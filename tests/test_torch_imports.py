"""Import hygiene of the port: every module of conformer_tpu_torch (the
parallel package's included), chip_smoke.py and
scripts/torch_train_micro_wer.py import without pulling in JAX, the JAX
package or gradio, importing builds nothing, and no process group is
made. This suite's conftest imports JAX in-process,
so the check runs in a fresh interpreter.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import conformer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conformer_tpu_torch.__path__, "conformer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
new = {"conformer_tpu_torch.ops.quant", "conformer_tpu_torch.ops.int8_matmul",
       "conformer_tpu_torch.ops.int8_ffn", "conformer_tpu_torch.ops.joint_lattice",
       "conformer_tpu_torch.ops.fbank_kernel", "conformer_tpu_torch.train.flops",
       "conformer_tpu_torch.decode.streaming", "conformer_tpu_torch.decode.stream_batch",
       "conformer_tpu_torch.serve.scheduler", "conformer_tpu_torch.serve.websocket_server",
       "conformer_tpu_torch.serve.clients", "conformer_tpu_torch.decode.beam",
       "conformer_tpu_torch.decode.beam_batched", "conformer_tpu_torch.decode.ctc_decode",
       "conformer_tpu_torch.decode.ctc_beam_batched", "conformer_tpu_torch.decode.rescoring",
       "conformer_tpu_torch.decode.search", "conformer_tpu_torch.models.decoder",
       "conformer_tpu_torch.train.profiling", "conformer_tpu_torch.data.native",
       "conformer_tpu_torch.tools.collect_librispeech",
       "conformer_tpu_torch.tools.compute_cmvn_stats", "conformer_tpu_torch.tools.convert_vocab",
       "conformer_tpu_torch.tools.gen_golden_fbank", "conformer_tpu_torch.parallel",
       "conformer_tpu_torch.parallel.distributed", "conformer_tpu_torch.parallel.mesh",
       "conformer_tpu_torch.parallel.sequence", "conformer_tpu_torch.parallel.pipeline",
       "conformer_tpu_torch.parallel.tensor", "conformer_tpu_torch.tools.make_micro_corpus",
       "conformer_tpu_torch.serve.gradio_server"}
assert new <= set(names), new - set(names)
import chip_smoke
import importlib.util
spec = importlib.util.spec_from_file_location("torch_train_micro_wer",
                                              "scripts/torch_train_micro_wer.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from conformer_tpu_torch.ops import cuda_build
bad = sorted(m for m in sys.modules if m in ("jax", "conformer_tpu", "websockets", "gradio")
             or m.startswith(("jax.", "jaxlib", "conformer_tpu.", "websockets.", "gradio.")))
assert not bad, bad
assert not cuda_build._libs
from conformer_tpu_torch.data import native
assert not native._state
import torch.distributed
assert not torch.distributed.is_initialized()
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    proc = _run(["-c", _CHECK], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 45       # every module was walked


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no card: the smoke must exit non-zero and print no
    result line; alone in a directory it must fail the same way."""
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            with open(os.path.join(REPO, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        proc = _run([str(script)], cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_main_needs_the_card_unless_asked():
    """``python -m conformer_tpu_torch.main`` defaults to the card: without
    CUDA it fails before building anything; --print_config needs no card."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "conformer_tpu_torch.main", "--config", "configs/conformer_m.json"]
    proc = subprocess.run([*base, "--eval"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = subprocess.run([*base, "--print_config"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and '"vocab_size": 5002' in proc.stdout
