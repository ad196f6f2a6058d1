"""Process groups for the port's tests: ``spawn`` starts ``n`` gloo processes
on the CPU, each running one of the worker functions below on a job written
by the test (a pickle), rank 0 writing the results beside it. The workers
import torch and the port only (no JAX), so that a process starts in a few
seconds; the tests compare the results with the JAX package in their own
process."""

from __future__ import annotations

import os
import pickle
import socket
import sys


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target, job_path: str, n: int = 4) -> list:
    """``n`` processes running ``target(rank, n, port, job_path)``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, n, port, job_path)) for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, timeout: float = 300.0) -> None:
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"gloo workers failed: exit codes {codes}")


def _env(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))


def _load(job_path: str) -> dict:
    with open(job_path, "rb") as f:
        return pickle.load(f)


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def _gathered(t, like):
    """``t`` split as the leaf ``like`` is over "model", gathered whole."""
    import torch

    from seamless_communication_torch.parallel.collectives import all_gather, model_shard

    s = model_shard(like)
    t = t.detach()
    return torch.cat(all_gather(t, s.axis), dim=s.dim) if s is not None else t


def _whole(tree):
    """A port tree with every leaf split over "model" gathered whole."""
    from seamless_communication_torch.train.trainer import map_tree

    return map_tree(lambda t: _gathered(t, t), tree)


def _mesh_case(case: dict, job: dict) -> dict:
    import torch

    from seamless_communication_torch.checkpoint.from_jax import (
        unity_params_from_jax, unity_params_to_numpy,
    )
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.parallel import pipeline as pl
    from seamless_communication_torch.parallel.collectives import local_heads
    from seamless_communication_torch.parallel.sharding import make_mesh
    from seamless_communication_torch.train.trainer import (
        FinetuneMode, FinetuneParams, UnitYFinetune, named_leaves,
    )

    cfg = get_arch(case["arch"])
    params = unity_params_from_jax(job["trees"][case["arch"]])
    ft = FinetuneParams(finetune_mode=FinetuneMode(case["mode"]), learning_rate=1e-3,
                        warmup_steps=2, float_dtype=torch.float32, **case["ft"])
    mesh = make_mesh(**case["mesh"])
    calls = {"n": 0}
    real = pl.pipeline_stack

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    pl.pipeline_stack = counting
    try:
        tr = UnitYFinetune(params, cfg, ft, mesh=mesh, device="cpu")
        grads = []
        update = tr.optimizer.step

        def keep_grads():
            # the gradient as the step gives it to the optimizer: frozen
            # leaves zero, summed over "data", before the clip
            grads.extend(p.grad.detach().clone() for p in tr.optimizer.params)
            return update()

        tr.optimizer.step = keep_grads
        m = tr.step(job["batches"][case["batch"]])
    finally:
        pl.pipeline_stack = real
    heads = local_heads(tr.params["speech_encoder"]["encoder"][0]["self_attn"]["q_proj"],
                        cfg.speech.conformer.num_heads)
    return {"loss": float(m["loss"]), "pipe_calls": calls["n"], "heads": heads,
            "params": unity_params_to_numpy(_whole(tr.params)),
            "grads": {".".join(path): _gathered(g, t).numpy()
                      for (path, t), g in zip(named_leaves(tr.params), grads)}}


def _pipe_case(S: int, mesh_kw: dict, job: dict) -> dict:
    import torch

    from seamless_communication_torch.parallel.pipeline import (
        pipeline_layers, pipeline_or_none, pipeline_stack,
    )
    from seamless_communication_torch.parallel.sharding import make_mesh

    mesh = make_mesh(**mesh_kw)
    p = job["pipe"]
    w = torch.tensor(p["w"], requires_grad=True)
    b = torch.tensor(p["b"], requires_grad=True)
    x = torch.tensor(p["x"], requires_grad=True)
    mask = torch.tensor(p["mask"])
    layers = [{"w": w[i], "b": b[i]} for i in range(w.shape[0])]

    def body(h, ex, lp):
        return torch.tanh(h @ lp["w"] + lp["b"]) * ex["mask"]

    y = pipeline_stack(body, layers, x, mesh=mesh, n_micro=S, extras={"mask": mask})
    (y ** 2).sum().backward()
    with pipeline_layers(mesh, n_micro=S):
        fallback = pipeline_or_none(lambda h, t, lp: h, layers[:3], x, {})
    return {"y": y.detach().numpy(), "gw": w.grad.numpy(), "gb": b.grad.numpy(),
            "gx": x.grad.numpy(), "fallback_none": fallback is None}


def _vocab_case(job: dict) -> dict:
    """The tied projection, its loss (whole and chunked) and the embedding
    lookup over a 1024-row table split over "model" (data 2, model 2)."""
    import torch

    from seamless_communication_torch.ops.modules import embedding
    from seamless_communication_torch.ops.transformer import tied_projection
    from seamless_communication_torch.parallel.collectives import model_shard
    from seamless_communication_torch.parallel.sharding import make_mesh, shard_params
    from seamless_communication_torch.train.loss import (
        chunked_tied_nll_loss, label_smoothed_nll_loss,
    )

    v = job["vocab"]
    mesh = make_mesh(data=2, model=2)
    tg = torch.tensor(v["targets"])
    out = {}
    for key in ("whole", "chunked"):
        embed = shard_params({"embedding": torch.tensor(v["table"], requires_grad=True)},
                             mesh)
        x = torch.tensor(v["x"], requires_grad=True)
        if key == "chunked":
            loss, n = chunked_tied_nll_loss(x, embed, tg, pad_idx=0, label_smoothing=0.2,
                                            ignore_prefix_size=1, chunk=3)
        else:
            loss, n = label_smoothed_nll_loss(tied_projection(embed, x), tg, pad_idx=0,
                                              label_smoothing=0.2, ignore_prefix_size=1,
                                              vocab_shard=model_shard(embed["embedding"]))
        (loss / n).backward()
        out[key] = {"loss": float(loss / n), "gx": x.grad.numpy(),
                    "gtable": _gathered(embed["embedding"].grad, embed["embedding"]).numpy()}
    out["lookup"] = embedding(embed, tg, scale=4.0).detach().numpy()
    return out


def _state_case(job: dict) -> dict:
    """One (data 2, model 2) S2T step, then its state and best model
    written as checkpoint directories; the state's entries, whole."""
    import torch

    from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.parallel.sharding import make_mesh
    from seamless_communication_torch.train.trainer import FinetuneParams, UnitYFinetune

    mesh = make_mesh(data=2, model=2)
    ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, float_dtype=torch.float32,
                        save_model_path=os.path.join(job["tmp"], "best_m2"))
    tr = UnitYFinetune(unity_params_from_jax(job["trees"]["tiny_v2"]), get_arch("tiny_v2"),
                       ft, mesh=mesh, device="cpu")
    tr.step(job["batches"]["b4"])
    tr.best_eval, tr.patience_left = 1.5, 2
    tr.save_state(os.path.join(job["tmp"], "state_m2"), step_nr=1)
    tr.save()
    return {k: v.numpy() for k, v in _whole(tr._state_tensors(1)).items()}


def parallel_worker(rank: int, world: int, port: int, job_path: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    _env(rank, world, port)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    job = _load(job_path)
    out = {"mesh": {c["name"]: _mesh_case(c, job) for c in job["mesh_cases"]},
           "pipe": {S: _pipe_case(S, kw, job) for S, kw in job["pipe_meshes"]},
           "vocab": _vocab_case(job), "state_m2": _state_case(job)}
    if rank == 0:
        _dump(out, job_path + ".out")
    dist.destroy_process_group()


def load_out(job_path: str):
    return _load(job_path + ".out")


# ---------------------------------------------------------------------------
# tests/test_torch_finetune_cli.py
# ---------------------------------------------------------------------------

def cli_worker(rank: int, world: int, port: int, job_path: str) -> None:
    """``m4t_finetune``'s ``main`` as ``torchrun`` starts it: the launcher's
    environment, no process group yet."""
    import torch

    torch.set_num_threads(1)
    _env(rank, world, port)
    job = _load(job_path)
    os.environ.update(job["env"])
    from seamless_communication_torch.cli import finetune

    res = finetune.main(job["argv"])
    if rank == 0:
        _dump({"losses": res.trainer.step_losses, "final_step": res.final_step,
               "world": int(os.environ["WORLD_SIZE"]),
               "mesh": dict(res.trainer.mesh.shape)}, job_path + ".out")
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":      # pragma: no cover
    sys.exit("tests/torch_gloo.py holds worker functions for the tests")
