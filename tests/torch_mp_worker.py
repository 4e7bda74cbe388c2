"""One rank of the port's multi-process tests (tests/test_torch_distributed.py,
test_torch_sequence_parallel.py, test_torch_pipeline.py,
test_torch_tensor_parallel.py). Not collected by
pytest (no test_ prefix); launched as

    python tests/torch_mp_worker.py '<json spec>'

with spec {repo, world, rank, port, out, cases: [{kind, name, ...}]}. Every
rank joins one gloo group on the CPU and runs the cases in order (their
collectives must line up), writing its results under ``out`` as
``<name>.rank<r>.npz`` / ``.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def _cfg(d: dict):
    from conformer_tpu_torch.config import Config

    return Config.from_dict(d)


def _params(path: str, key: str | None = None):
    from conformer_tpu_torch.params import load_jax_npz

    tree = load_jax_npz(path, "cpu")
    return tree[key] if key else tree


def _batch(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _grads(leaves: list[tuple[str, "object"]], loss) -> dict:
    import torch

    gs = torch.autograd.grad(loss, [v for _, v in leaves], allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g).detach()
            for (k, v), g in zip(leaves, gs)}


def probe_loss(out, mask, probe: np.ndarray):
    """sum(mask * out * probe): ``probe`` is a fixed N(0, 1) tensor of
    out's shape, so that the gradient reaches every leaf (the sum of
    squares after the final LayerNorm is nearly constant)."""
    import torch

    return (torch.where(mask[..., None], out, 0.0) * torch.from_numpy(probe)).sum()


def case_host(spec, case, mesh_mod, pdist):
    """allsum_host_scalars, barrier, batch sharding and the pipeline's
    gather of stacked leaves."""
    import torch

    from conformer_tpu_torch.parallel.pipeline import make_pipeline_mesh

    r = spec["rank"]
    sums = pdist.allsum_host_scalars({"b": 0.25 * (r + 1), "a": float(r + 1)})
    pdist.barrier()
    mesh = mesh_mod.make_mesh()
    rows = mesh_mod.shard_batch({"x": np.arange(8)[:, None], "n": np.int32(3)}, mesh)
    pmesh = make_pipeline_mesh(1, spec["world"])
    tree = {"encoder": {"layers": {"w": torch.full((2, 3), float(r))}, "after_norm":
                        torch.arange(3.0)}, "step": 7}
    host = pdist.gather_tree_to_host(tree, pmesh)
    return {"sums": sums, "coords": mesh.coords, "rows": rows["x"][:, 0].tolist(),
            "n": int(rows["n"]), "layers": host["encoder"]["layers"]["w"].tolist(),
            "after_norm": host["encoder"]["after_norm"].tolist(), "step": host["step"],
            "slice": [mesh_mod.batch_sharding(mesh, 8).start,
                      mesh_mod.batch_sharding(mesh, 8).stop]}


def case_trainer_grads(spec, case, mesh_mod, pdist):
    """One step's reduced gradients and metrics from ``Trainer.step_grads``
    on this rank's rows (``rows`` of the global batch), then the step."""
    from conformer_tpu_torch.train.loop import Trainer

    cfg = _cfg(case["config"])
    tr = Trainer(cfg, params=_params(case["params"]), device="cpu")
    b = _batch(case["batch"])
    local = {k: v[case["rows"][str(spec["rank"])]] for k, v in b.items()}
    grads, metrics, norm = tr.step_grads([local])
    out = {f"g:{k}": g.numpy() for k, g in grads.items()}
    out["metrics"] = metrics.numpy()
    out["norm"] = norm.numpy()
    if case.get("step"):
        m = tr.train_step([local])
        out["step_loss"] = np.float64(m["loss"])
        out["step_norm"] = np.float64(m["grad_norm"])
    if case.get("ckpt_in"):             # a one-process checkpoint into the mesh, a step, a save
        tr.restore(case["ckpt_in"])
        m = tr.train_step([local])
        out["restored_step_loss"] = np.float64(m["loss"])
        out["ckpt"] = np.str_(tr.save())
        for k, v in tr.params["encoder"]["layers"]["norm_ff"].items():
            out[f"stage_norm_ff:{k}"] = v.detach().numpy()
    return out


def case_mismatch(spec, case, mesh_mod, pdist):
    """A step on data shards whose local batches differ: rank 1's rows cut
    to ``cut`` fewer frames. Returns the ValueError's text ("" if none)."""
    from conformer_tpu_torch.train.loop import Trainer

    cfg = _cfg(case["config"])
    tr = Trainer(cfg, params=_params(case["params"]), device="cpu")
    b = _batch(case["batch"])
    local = {k: v[case["rows"][str(spec["rank"])]] for k, v in b.items()}
    if spec["rank"] == 1:
        t = local["feats"].shape[1] - case["cut"]
        local.update(feats=local["feats"][:, :t],
                     feat_lengths=np.minimum(local["feat_lengths"], t))
    try:
        tr.step_grads([local])
    except ValueError as e:
        return {"raised": np.str_(e)}
    return {"raised": np.str_("")}


def case_chunks(spec, case, mesh_mod, pdist):
    """The dynamic chunk sizes each rank draws over a few training steps."""
    from conformer_tpu_torch.models import masks
    from conformer_tpu_torch.train.loop import Trainer

    drawn = []
    orig = masks.sample_dynamic_chunk

    def record(gen, max_len, left):
        drawn.append(orig(gen, max_len, left))
        return drawn[-1]

    masks.sample_dynamic_chunk = record
    try:
        cfg = _cfg(case["config"])
        tr = Trainer(cfg, params=_params(case["params"]), device="cpu")
        b = _batch(case["batch"])
        local = {k: v[case["rows"][str(spec["rank"])]] for k, v in b.items()}
        for _ in range(case["steps"]):
            tr.train_step([local])
    finally:
        masks.sample_dynamic_chunk = orig
    return {"drawn": [list(d) for d in drawn]}


def case_seq(spec, case, mesh_mod, pdist):
    """encoder_forward_seq on this data shard's rows: the output and,
    with ``grads``, the gradients of sum(mask * out^2) over the global
    batch, summed over the seq group and then the data group."""
    import torch
    import torch.distributed as dist

    from conformer_tpu_torch.config import ModelConfig
    from conformer_tpu_torch.parallel.sequence import encoder_forward_seq, make_seq_mesh
    from conformer_tpu_torch.train.optimizer import leaf_paths

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in case["model"].items()})
    mesh = make_seq_mesh(case["data"], case["seq"])
    p = _params(case["params"], "encoder")
    b = mesh_mod.shard_batch(_batch(case["batch"]), mesh)
    leaves = [(k, v.requires_grad_()) for k, v in leaf_paths(p) if "pos_table" not in k]
    out, mask = encoder_forward_seq(p, torch.from_numpy(b["feats"]),
                                    torch.from_numpy(b["lens"]), cfg, mesh=mesh)
    res = {"out": out.detach().numpy(), "mask": mask.numpy()}
    if case.get("grads"):
        grads = _grads(leaves, probe_loss(out, mask, b["probe"]))
        for k, g in grads.items():
            if mesh.group("seq") is not None:
                dist.all_reduce(g, group=mesh.group("seq"))
            if mesh.group("data") is not None:
                dist.all_reduce(g, group=mesh.group("data"))
            res[f"g:{k}"] = g.numpy()
    return res


def case_pipe(spec, case, mesh_mod, pdist):
    """encoder_forward_pipelined on this data shard's rows: the output and
    the raw gradients of this rank's sum(mask * out^2), as each stage holds
    them (the test assembles them by the module's rule)."""
    import torch

    from conformer_tpu_torch.config import ModelConfig
    from conformer_tpu_torch.parallel.pipeline import (encoder_forward_pipelined,
                                                       make_pipeline_mesh, shard_stacked_layers)
    from conformer_tpu_torch.train.optimizer import leaf_paths

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in case["model"].items()})
    mesh = make_pipeline_mesh(case["data"], case["pipe"])
    p = _params(case["params"], "encoder")
    p["layers"] = shard_stacked_layers(p["layers"], mesh)
    b = mesh_mod.shard_batch(_batch(case["batch"]), mesh)
    leaves = [(k, v.requires_grad_()) for k, v in leaf_paths(p) if "pos_table" not in k]
    out, mask = encoder_forward_pipelined(p, torch.from_numpy(b["feats"]),
                                          torch.from_numpy(b["lens"]), cfg, mesh,
                                          num_microbatches=case["m"])
    res = {"out": out.detach().numpy(), "mask": mask.numpy(),
           "coords": np.asarray([mesh.coord("data"), mesh.coord("pipe")])}
    for k, g in _grads(leaves, probe_loss(out, mask, b["probe"])).items():
        res[f"g:{k}"] = g.numpy()
    return res


def _full(tr, tree) -> dict:
    """{path: whole numpy leaf} of a tree of this rank's model shards."""
    from conformer_tpu_torch.parallel.mesh import gather_leaf
    from conformer_tpu_torch.train.optimizer import leaf_paths

    return {k: gather_leaf(k, v, tr.mesh).detach().numpy().copy() for k, v in leaf_paths(tree)
            if hasattr(v, "ndim")}


def case_tp(spec, case, mesh_mod, pdist):
    """A ``Trainer`` on the mesh of ``case["config"]``'s train.mesh_* (the
    model axis among them), each rank on its data shard of the global
    batch. In order, as the case asks: ``grads``, the step's reduced
    gradients (``step_grads``, deterministic) gathered over "model", its
    metrics and norm; ``step``, one ``train_step`` and the whole params
    after it; ``ckpt_in``, a restore of that checkpoint, a step, a
    ``save`` (its path) and one more step, with the whole params and Adam
    moments after the restore and after the first step, and each step's
    loss; ``validate``, the WER of ``Trainer.validate`` in
    each of ``modes`` on this rank's batch of ``validate``, and the
    predictions it wrote."""
    from conformer_tpu_torch.train.loop import Trainer

    cfg = _cfg(case["config"])
    tr = Trainer(cfg, params=_params(case["params"]), device="cpu")
    local = mesh_mod.shard_batch(_batch(case["batch"]), tr.mesh)
    out = {"coords": np.asarray([tr.mesh.coord(a) for a in ("data", "seq", "model")])}
    if case.get("grads"):
        grads, metrics, norm = tr.step_grads([local], deterministic=True)
        out.update({f"g:{k}": v for k, v in _full(tr, grads).items()})
        out["metrics"], out["norm"] = metrics.numpy(), norm.numpy()
    if case.get("step"):
        m = tr.train_step([local])
        out["step_loss"], out["step_norm"] = np.float64(m["loss"]), np.float64(m["grad_norm"])
        out.update({f"p:{k}": v for k, v in _full(tr, tr.params).items()})
    if case.get("ckpt_in"):
        tr.restore(case["ckpt_in"])
        out.update({f"r:{k}": v for k, v in _full(tr, tr.params).items()})
        out.update({f"rmu:{k}": v for k, v in _full(tr, tr.opt_state.mu).items()})
        out["loss2"] = np.float64(tr.train_step([local])["loss"])
        out.update({f"p2:{k}": v for k, v in _full(tr, tr.params).items()})
        out.update({f"mu2:{k}": v for k, v in _full(tr, tr.opt_state.mu).items()})
        out["ckpt"] = np.str_(tr.save())
        out["loss3"] = np.float64(tr.train_step([local])["loss"])
    if case.get("validate"):
        with np.load(case["validate"]) as z:
            dev = [{"feats": z[f"feats{r}"], "feat_lengths": z[f"lens{r}"],
                    "keys": [f"r{r}u{i}" for i in range(len(z[f"lens{r}"]))],
                    "transcripts": [str(t) for t in z[f"text{r}"]]}
                   for r in range(spec["world"]) if f"feats{r}" in z.files]
        for mode in case["modes"]:
            tr.cfg.decode.mode = mode
            out[f"wer:{mode}"] = np.float64(tr.validate(dev[tr.rank:tr.rank + 1]))
            name = f"tmp_prediction.rank{tr.rank}.txt"
            with open(os.path.join(cfg.train.checkpoint_dir, name)) as f:
                out[f"pred:{mode}"] = np.str_(f.read())
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(repo: str) -> dict:
    """The test process's environment without its JAX settings (the ranks
    import no JAX), one thread a rank."""
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def launch(repo: str, world: int, cases: list[dict], out: str) -> list:
    """Start ``world`` ranks of this script on ``cases``; their output
    goes to ``out/worker.rank<r>.log``."""
    port = free_port()
    procs = []
    for rank in range(world):
        spec = {"repo": repo, "world": world, "rank": rank, "port": port, "out": out,
                "cases": cases}
        log = open(os.path.join(out, f"worker.rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, __file__, json.dumps(spec)],
                                       env=worker_env(repo), stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def join(procs: list, timeout: float) -> list[str]:
    """Wait for every process (at most ``timeout`` s in all; past it all are
    killed); returns the failures, each with the end of its log."""
    deadline = time.monotonic() + timeout
    failed = []
    for proc, log in procs:
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode != 0:
            with open(log.name) as f:
                failed.append(f"{log.name} rc {proc.returncode}:\n{f.read()[-3000:]}")
    return failed


CASES = {"host": case_host, "trainer_grads": case_trainer_grads, "chunks": case_chunks,
         "mismatch": case_mismatch, "seq": case_seq, "pipe": case_pipe, "tp": case_tp}


def main() -> None:
    spec = json.loads(sys.argv[1])
    sys.path.insert(0, spec["repo"])
    import torch

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    from conformer_tpu_torch.parallel import distributed as pdist
    from conformer_tpu_torch.parallel import mesh as mesh_mod

    assert pdist.maybe_initialize_distributed(f"127.0.0.1:{spec['port']}", spec["world"],
                                              spec["rank"], device="cpu")
    try:
        for case in spec["cases"]:
            res = CASES[case["kind"]](spec, case, mesh_mod, pdist)
            stem = os.path.join(spec["out"], f"{case['name']}.rank{spec['rank']}")
            if isinstance(res, dict) and all(isinstance(v, np.ndarray) or np.isscalar(v)
                                             for v in res.values()):
                np.savez(stem + ".npz", **res)
            else:
                with open(stem + ".json", "w") as f:
                    json.dump(res, f)
    finally:
        pdist.destroy()
    print("WORKER_OK", spec["rank"], flush=True)


if __name__ == "__main__":
    main()
