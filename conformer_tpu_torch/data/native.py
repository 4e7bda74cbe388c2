"""ctypes bindings of the host audio runtime (``runtime/audio_runtime.cc``,
the port's own copy of the JAX package's): wav decoding, resampling,
Kaldi-style fbank and a multi-threaded batch fbank, in C++ on the host.

The library is built at first use, never at import: ``g++`` with the JAX
package's ``runtime/Makefile`` flags compiles the source into
``build/host/libaudio_runtime-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored). The hash covers the source, the flags,
``g++ --version`` and the target ``-march=native`` resolves to, so an
edited source, another compiler or another CPU never loads a stale
library. Each build goes to a name of its own and is renamed into place,
so processes that build at once leave one whole library.

Which path the pipeline takes is the JAX package's rule, native when
available, made visible: without ``g++`` on PATH ``native_available()`` is
False and one RuntimeWarning names the numpy path taken; a failed build
raises with the compiler's output; a library whose ``crt_abi_version()``
is not ``ABI_VERSION`` raises (the JAX package's binding warns and falls
back there).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "runtime" / "audio_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")   # runtime/Makefile
ABI_VERSION = 2     # crt_abi_version(): v2 = dither and seed arguments of the fbanks

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded CDLL or None (no g++), once decided


def compiler() -> str | None:
    return shutil.which("g++")


def library_path(cxx: str) -> Path:
    """The library's path: its hash covers the source, the flags, the
    compiler's version and the target that -march=native resolves to on
    this machine (a checkout copied to another CPU builds anew)."""
    def ask(*args: str) -> bytes:
        return subprocess.run([cxx, *args], capture_output=True, check=True).stdout

    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                          + ask("--version") + ask("-march=native", "-Q", "--help=target"))
    return BUILD_DIR / f"libaudio_runtime-{digest.hexdigest()[:12]}.so"


def build(cxx: str) -> Path:
    """Compile the runtime unless its library is built; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    so = library_path(cxx)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def bind(path) -> ctypes.CDLL:
    """Load the library at ``path`` and type its entry points; raises
    RuntimeError when its ABI version is missing or not ``ABI_VERSION``."""
    lib = ctypes.CDLL(str(path))
    try:
        abi = lib.crt_abi_version
    except AttributeError:
        raise RuntimeError(f"{path} exports no crt_abi_version (expected ABI "
                           f"v{ABI_VERSION})") from None
    abi.restype, abi.argtypes = ctypes.c_int32, []
    if abi() != ABI_VERSION:
        raise RuntimeError(f"{path} has ABI v{abi()}, expected v{ABI_VERSION}")
    f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    lib.crt_decode_wav.restype = ctypes.c_int64
    lib.crt_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32,
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.crt_resample.restype = ctypes.c_int64
    lib.crt_resample.argtypes = [f32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32]
    lib.crt_fbank.restype = ctypes.c_int64
    lib.crt_fbank.argtypes = [f32, ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
                              ctypes.c_float, ctypes.c_float, ctypes.c_float,
                              ctypes.c_uint64, f32]
    lib.crt_fbank_batch.restype = None
    lib.crt_fbank_batch.argtypes = [f32, i64, i64, ctypes.c_int32, ctypes.c_float,
                                    ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                                    ctypes.c_float, ctypes.c_uint64, f32, i64, ctypes.c_int32]
    return lib


def _load() -> ctypes.CDLL | None:
    """The runtime, built and bound at the first call; None without g++."""
    with _lock:
        if "lib" not in _state:
            cxx = compiler()
            if cxx is None:
                warnings.warn("g++ is not on PATH: the host audio runtime cannot be built; "
                              "features and wav decoding take the numpy path",
                              RuntimeWarning, stacklevel=3)
                _state["lib"] = None
            else:
                _state["lib"] = bind(build(cxx))
        return _state["lib"]


def reset() -> None:
    """Forget the loaded library, so that the next call decides again."""
    with _lock:
        _state.clear()


def native_available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the host audio runtime is not available (no g++)")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 [-1, 1], sample rate); ValueError if the
    runtime cannot parse them."""
    lib = _lib()
    sr = ctypes.c_int32(0)
    n = lib.crt_decode_wav(data, len(data), None, ctypes.byref(sr))
    if n < 0:
        raise ValueError("native wav parse failed")
    out = np.empty(n, np.float32)
    lib.crt_decode_wav(data, len(data), _fptr(out), ctypes.byref(sr))
    return out, int(sr.value)


def resample(wave: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Windowed-sinc resampling (48 taps)."""
    lib = _lib()
    wave = np.ascontiguousarray(wave, np.float32)
    n = lib.crt_resample(_fptr(wave), len(wave), in_rate, out_rate, None)
    out = np.empty(n, np.float32)
    lib.crt_resample(_fptr(wave), len(wave), in_rate, out_rate, _fptr(out))
    return out


def fbank(
    wave: np.ndarray,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """wave [N] (already x 2**15) -> log-mel fbank [T, num_mel_bins] float32.
    dither > 0 adds counter-based Gaussian noise, the same for one ``seed``."""
    lib = _lib()
    wave = np.ascontiguousarray(wave, np.float32)
    args = (len(wave), sample_rate, num_mel_bins, frame_length, frame_shift, dither, seed)
    t = lib.crt_fbank(_fptr(wave), *args, None)
    out = np.empty((t, num_mel_bins), np.float32)
    if t:
        lib.crt_fbank(_fptr(wave), *args, _fptr(out))
    return out


def fbank_batch(
    waves: list[np.ndarray],
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    num_threads: int = 2,
    dither: float = 0.0,
    seed: int = 0,
) -> list[np.ndarray]:
    """``fbank`` of each waveform on ``num_threads`` threads; utterance i
    dithers with a seed made from (``seed``, i), whatever thread takes it."""
    lib = _lib()
    ws = int(sample_rate * frame_length / 1000)
    shift = int(sample_rate * frame_shift / 1000)
    lengths = np.asarray([len(w) for w in waves], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    concat = (np.concatenate([np.ascontiguousarray(w, np.float32) for w in waves])
              if waves else np.zeros(0, np.float32))
    t_frames = np.asarray([1 + (n - ws) // shift if n >= ws else 0 for n in lengths], np.int64)
    out_offsets = np.concatenate([[0], np.cumsum(t_frames)[:-1]]).astype(np.int64)
    outs = np.empty(int(t_frames.sum()) * num_mel_bins, np.float32)
    lib.crt_fbank_batch(_fptr(concat), _iptr(offsets), _iptr(lengths), len(waves),
                        sample_rate, num_mel_bins, frame_length, frame_shift, dither, seed,
                        _fptr(outs), _iptr(out_offsets), num_threads)
    return [outs[o * num_mel_bins:(o + t) * num_mel_bins].reshape(t, num_mel_bins)
            for o, t in zip(out_offsets.tolist(), t_frames.tolist())]
