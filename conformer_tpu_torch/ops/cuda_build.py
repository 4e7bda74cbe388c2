"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, ints, the stream)
and compiles on its own into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (``build/`` is git-ignored). The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source never loads a stale library.
Nothing is built when a module is imported: the first launch builds, or a
caller builds every kernel up front with ``build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("rel_flash_attention", "rel_flash_attention_bwd", "conv_block", "simple_lattice",
           "rnnt_lattice", "ctc_dp", "int8_matmul", "int8_ffn", "joint_lattice", "fbank")
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on Hopper
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns nvcc's output (the
    ptxas register and shared-memory report) per name built, after a first
    line "nvcc: <s> s" with the seconds from the start to that process's
    end."""
    t0 = time.perf_counter()
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, so, tmp, proc))
    logs: dict[str, str] = {}
    ends: dict[str, float] = {}

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        ends[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, _, _, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for name, so, tmp, proc in procs:
        out = logs[name] = f"nvcc: {ends[name]:.1f} s\n{logs[name]}"
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_function(name: str, symbol: str, n_ptrs: int, n_ints: int,
                  n_floats: int = 0):
    """The C entry ``symbol`` of kernel library ``name`` (built first if
    needed), typed as ``n_ptrs`` pointers (the stream included), then
    ``n_ints`` ints, then ``n_floats`` floats, returning an int (the CUDA
    error code of the launch)."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = (
                [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                + [ctypes.c_float] * n_floats
            )
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
        return fn


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
