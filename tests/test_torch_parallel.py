"""Data-, tensor- and pipeline-parallel training of the port
(``parallel/*``, the trainer's mesh paths, checkpoint directories,
``offload_dots``) against the JAX package on the CPU, fp32, JAX at matmul
precision ``highest``.

One module fixture starts four gloo processes (``tests/torch_gloo.py
parallel_worker``), which run every mesh case while this process computes
JAX's references:
- one ``UnitYFinetune`` step of tiny_v2 S2T under (data 2, model 2),
  (data 1, model 4), (data 2, pipe 2, remat "full") and (model 2, pipe 2),
  of tiny_v2 NAR S2S and tiny_v1 AR S2S under (data 2, model 2): the loss
  within 1e-4 and every updated parameter within 2e-4 of JAX's unsharded
  train step of ``UnitYFinetune`` on the same weights and batch
  (``tests/integration/test_finetune.py``'s tolerances), and the gradient
  that the step gives the optimizer, every leaf gathered whole, within 1e-4
  of its norm leaf by leaf; the pipelined steps call ``pipeline_stack`` at
  least twice;
- ``pipeline_stack`` with per-sample extras and its gradients against JAX's
  over its virtual devices at S = 2 and 4, and the ``None`` fallback when the
  layer count is not a multiple of S;
- the tied projection's loss (whole and chunked) and the lookup over a
  1024-row table split over "model" against JAX's unsplit functions;
- a (data 2, model 2) train state and best model as checkpoint directories,
  restored in one process exactly.
In this process alone: every leaf's spec against JAX's
``with_param_shardings`` at model 2 and 4, directory round trips, an exact
resume, and ``offload_dots`` gradients bitwise equal to ``dots``'s."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.parallel.sharding import (
    make_mesh as jmake_mesh, with_param_shardings as jshardings,
)
from seamless_communication_tpu.train import trainer as jtrainer

from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax, unity_params_to_numpy,
)
from seamless_communication_torch.checkpoint.serialize import (
    flat_tensors, load_params, save_params,
)
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.parallel.sharding import Mesh, with_param_shardings
from seamless_communication_torch.train import trainer as ttrainer
from seamless_communication_torch.train.trainer import (
    FinetuneParams, UnitYFinetune, batch_to, named_leaves, trainable_copy,
)

from tests import torch_gloo
from tests.integration.test_finetune import _batches, _s2s_ar_batch, _s2s_nar_batch

S2T, S2S = "SPEECH_TO_TEXT", "SPEECH_TO_SPEECH"
MESH_CASES = [
    dict(name="s2t_data2_model2", arch="tiny_v2", mesh=dict(data=2, model=2), mode=S2T,
         batch="b4", ft={}),
    dict(name="s2t_model4", arch="tiny_v2", mesh=dict(data=1, model=4), mode=S2T,
         batch="b4", ft={}),
    dict(name="s2t_data2_pipe2_remat", arch="tiny_v2", mesh=dict(data=2, model=1, pipe=2),
         mode=S2T, batch="b4", ft=dict(pp_microbatches=2, remat="full")),
    dict(name="s2t_model2_pipe2", arch="tiny_v2", mesh=dict(data=1, model=2, pipe=2),
         mode=S2T, batch="b4", ft=dict(pp_microbatches=2)),
    dict(name="nar_s2s_data2_model2", arch="tiny_v2", mesh=dict(data=2, model=2), mode=S2S,
         batch="nar", ft={}),
    dict(name="ar_s2s_data2_model2", arch="tiny_v1", mesh=dict(data=2, model=2), mode=S2S,
         batch="ar", ft={}),
]
PIPE_MESHES = [(2, dict(data=2, model=1, pipe=2)), (4, dict(data=1, model=1, pipe=4))]


def _b4():
    """The 4-row S2T batch of JAX's pipeline test (B divides data x micro)."""
    rng = np.random.default_rng(11)
    B = 4
    return {"fbank": rng.standard_normal((B, 64, 80)).astype(np.float32),
            "fbank_lens": np.array([64, 48, 64, 56], np.int32),
            "prev_tokens": rng.integers(4, 250, (B, 8)).astype(np.int32),
            "target_tokens": rng.integers(4, 250, (B, 8)).astype(np.int32),
            "target_lens": np.array([8, 6, 8, 7], np.int32)}


def _compare(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return sum(_compare(got[k], want[k], rtol, atol, f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return sum(_compare(g, w, rtol, atol, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=path)
    return 1


def _compare_grads(got: dict, want: dict, tol: float = 1e-4) -> None:
    """The gradient as the step gives it to the optimizer: the whole tree
    and every leaf within ``tol`` of its norm (``||dg|| / ||g||``); frozen
    leaves exactly zero. An attention's ``k_proj`` bias, whose exact
    gradient is 0 (it adds the same logit to a whole softmax row), is held
    to ``tol`` of the norm of the same projection's weight gradient."""
    assert set(got) == set(want)
    sq = sq_ref = 0.0
    for k, w in want.items():
        dg = float(np.linalg.norm(got[k] - w))
        ref = float(np.linalg.norm(w))
        sq, sq_ref = sq + dg ** 2, sq_ref + ref ** 2
        if k.endswith("k_proj.bias"):
            ref = float(np.linalg.norm(want[k[:-len("bias")] + "weight"]))
        assert dg <= tol * ref, (k, dg, ref)
    assert sq ** 0.5 <= tol * sq_ref ** 0.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo workers' results, and JAX's references computed meanwhile."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("parallel")
    trees = {arch: jax.tree.map(np.asarray, junity.unity_init(jax.random.PRNGKey(1),
                                                              jget_arch(arch)))
             for arch in ("tiny_v2", "tiny_v1")}
    batches = {"b4": _b4(), "nar": _s2s_nar_batch(), "ar": _s2s_ar_batch()}
    rng = np.random.default_rng(5)
    L, B, D = 4, 8, 8
    pipe = {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, 4, D)).astype(np.float32),
            "mask": (rng.uniform(size=(B, 4, 1)) > 0.2).astype(np.float32)}
    targets = rng.integers(4, 1024, (2, 5)).astype(np.int64)
    targets[1, 3:] = 0
    vocab = {"table": (rng.standard_normal((1024, 16)) * 0.25).astype(np.float32),
             "x": rng.standard_normal((2, 5, 16)).astype(np.float32), "targets": targets}
    job = {"trees": trees, "batches": batches, "mesh_cases": MESH_CASES,
           "pipe_meshes": PIPE_MESHES, "pipe": pipe, "vocab": vocab, "tmp": str(d)}
    path = str(d / "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    def reference(arch, mode, key):
        """JAX's train step of ``UnitYFinetune`` (its ``make_train_step``,
        optimizer and frozen modules), with one transformation ahead of the
        optimizer that keeps the gradient it is given (frozen leaves masked,
        before the clip) as its state: the loss, the updated parameters and
        that gradient, a port tree."""
        cfg = jget_arch(arch)
        ft = jtrainer.FinetuneParams(finetune_mode=jtrainer.FinetuneMode(mode),
                                     learning_rate=1e-3, warmup_steps=2)
        tr = jtrainer.UnitYFinetune(trees[arch], cfg, ft)
        keep = optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
        step = jtrainer.make_train_step(
            cfg, optax.chain(keep, tr.optimizer), label_smoothing=ft.label_smoothing,
            mode=ft.finetune_mode, frozen_predicate=jtrainer.freeze_modules("text_encoder"))
        p, (grads, _), m = jax.jit(step)(
            tr.params, (keep.init(tr.params), tr.opt_state), batches[key])
        grads = jax.tree.map(np.asarray, grads)
        port = unity_params_from_jax(grads)
        if "text_encoder" in grads:
            # the converter ties the text encoder's table to the decoder's;
            # their gradients are two (the encoder's frozen to zeros)
            port["text_encoder"]["embed"] = to_torch(grads["text_encoder"]["embed"])
        grads = port
        return (float(m["loss"]), jax.tree.map(np.asarray, p),
                {".".join(path): g.numpy() for path, g in named_leaves(grads)})

    procs = torch_gloo.spawn(torch_gloo.parallel_worker, path)
    try:
        # the three jits compile side by side (XLA releases the GIL)
        cases = (("tiny_v2", S2T, "b4"), ("tiny_v2", S2S, "nar"), ("tiny_v1", S2S, "ar"))
        with ThreadPoolExecutor(len(cases)) as pool:
            refs = dict(zip(cases, pool.map(lambda c: reference(*c), cases)))
    finally:
        torch_gloo.join(procs)
    return {"out": torch_gloo.load_out(path), "refs": refs, "job": job, "dir": d}


@pytest.mark.parametrize("case", MESH_CASES, ids=[c["name"] for c in MESH_CASES])
def test_mesh_step_matches_unsharded_jax(runs, case):
    got = runs["out"]["mesh"][case["name"]]
    loss, params, grads = runs["refs"][(case["arch"], case["mode"], case["batch"])]
    assert abs(got["loss"] - loss) < 1e-4
    assert _compare(got["params"], params, 2e-4, 2e-4) == len(jax.tree.leaves(params))
    # AdamW's first step from zero moments moves an element by the sign of
    # its gradient and the clip scales every leaf alike, so only the
    # gradient shows one counted twice or averaged where it is summed
    _compare_grads(got["grads"], grads)
    if "pipe" in case["mesh"]:
        assert got["pipe_calls"] >= 2, "pipeline_stack never engaged"
    heads = get_arch(case["arch"]).speech.conformer.num_heads
    assert got["heads"] == heads // case["mesh"]["model"]


@pytest.mark.parametrize("S", [S for S, _ in PIPE_MESHES])
def test_pipeline_stack_matches_jax(runs, S):
    """JAX's ``pipeline_stack`` over S of its virtual devices (tanh layers,
    a per-sample mask as extras, n_micro = S) and its gradients."""
    from jax.sharding import Mesh as JMesh

    from seamless_communication_tpu.parallel.pipeline import pipeline_stack as jstack

    p = runs["job"]["pipe"]
    mesh = JMesh(np.asarray(jax.devices()[:S]).reshape(S), ("pipe",))
    stacked = {"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}
    x, extras = jnp.asarray(p["x"]), {"mask": jnp.asarray(p["mask"])}

    def body(h, ex, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]) * ex["mask"]

    def loss(s, x):
        y = jstack(body, s, x, mesh=mesh, axis="pipe", n_micro=S, extras=extras)
        return jnp.sum(y ** 2), y

    (_, y), (gs, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, x)
    got = runs["out"]["pipe"][S]
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=2e-5, atol=2e-5)
    for k, g in (("gw", gs["w"]), ("gb", gs["b"]), ("gx", gx)):
        np.testing.assert_allclose(got[k], np.asarray(g), rtol=1e-4, atol=1e-4, err_msg=k)
    assert got["fallback_none"], "3 layers over S stages must fall back to the loop"


def test_vocab_split_loss_matches_jax(runs):
    """Over a 1024-row table split over "model": the label-smoothed loss of
    the tied projection, whole and in chunks of 3 positions, and its
    gradients against JAX's ``label_smoothed_nll_loss`` of the whole table;
    the lookup against the table's rows."""
    from seamless_communication_tpu.train.loss import label_smoothed_nll_loss

    v = runs["job"]["vocab"]

    def objective(x, table):
        loss, n = label_smoothed_nll_loss(x @ table.T, jnp.asarray(v["targets"]),
                                          pad_idx=0, label_smoothing=0.2,
                                          ignore_prefix_size=1)
        return loss / n

    want, (gx, gt) = jax.value_and_grad(objective, argnums=(0, 1))(
        jnp.asarray(v["x"]), jnp.asarray(v["table"]))
    out = runs["out"]["vocab"]
    for key in ("whole", "chunked"):
        assert abs(out[key]["loss"] - float(want)) < 1e-5, key
        np.testing.assert_allclose(out[key]["gx"], np.asarray(gx), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out[key]["gtable"], np.asarray(gt), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out["lookup"], v["table"][v["targets"]] * 4.0)


def test_state_saved_under_model2_restores_in_one_process(runs):
    """The (data 2, model 2) trainer's state directory restores into a
    trainer of one process: parameters, AdamW's moments, the step and the
    counters equal the gathered shards exactly; the best-model directory
    loads back leaf for leaf."""
    want = runs["out"]["state_m2"]
    tr = UnitYFinetune(unity_params_from_jax(runs["job"]["trees"]["tiny_v2"]),
                       get_arch("tiny_v2"), FinetuneParams(float_dtype=torch.float32),
                       device="cpu")
    assert tr.restore_state(str(runs["dir"] / "state_m2")) == 1
    assert (tr.best_eval, tr.patience_left, tr.optimizer.steps_taken()) == (1.5, 2, 1)
    got = tr._state_tensors(1)
    assert set(got) == set(want)
    for k, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[k], err_msg=k)
    best = flat_tensors(load_params(str(runs["dir"] / "best_m2")))
    params = {k[len("params."):]: v for k, v in want.items() if k.startswith("params.")}
    assert set(best) == set(params)
    for k, t in best.items():
        np.testing.assert_array_equal(t.numpy(), params[k], err_msg=k)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny_v2", "tiny_v1"])
@pytest.mark.parametrize("model", [2, 4])
def test_specs_equal_jax(arch, model):
    """Every leaf's spec equals JAX's ``with_param_shardings`` on a
    (data 1, model m) mesh, without JAX's stacked layer axis."""
    jp = jax.eval_shape(lambda: junity.unity_init(jax.random.PRNGKey(0), jget_arch(arch)))
    jspecs = jshardings(jp, jmake_mesh(data=1, model=model))
    tp = unity_params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp))
    specs = with_param_shardings(tp, Mesh({"data": 1, "model": model}, {}))
    jleaves = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda s: hasattr(
        s, "spec"))[0]
    jmap = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): tuple(s.spec)
            for kp, s in jleaves}
    n_split = 0
    for path, _ in named_leaves(tp):
        spec = specs
        for p in path:
            spec = spec[int(p)] if isinstance(spec, list) else spec[p]
        stacked = [i for i, p in enumerate(path) if p.isdigit()
                   and path[i - 1] in ("encoder", "layers", "decoder_layers")]
        jpath = tuple(p for i, p in enumerate(path) if i not in stacked)
        jspec = jmap[jpath]
        if stacked and jspec:
            assert jspec[0] is None
            jspec = jspec[1:]
        assert spec == jspec, (path, spec, jspec)
        n_split += "model" in spec
    assert n_split > 0


def test_params_directory_round_trip(tmp_path):
    """``save_params`` / ``load_params`` of a directory: every leaf back,
    bf16 and int8 leaves included; a .npz still holds a tree."""
    from seamless_communication_torch.ops.quantization import quantize_params

    tree = unity_params_from_jax(jax.tree.map(np.asarray, junity.unity_init(
        jax.random.PRNGKey(2), jget_arch("tiny_v2"))))
    ln = tree["speech_encoder"]["inner_layer_norm"]
    ln["scale"] = ln["scale"].to(torch.bfloat16)
    for t, name in ((tree, "fp"), (quantize_params(tree, min_size=1), "int8")):
        save_params(str(tmp_path / name), t)
        back = flat_tensors(load_params(str(tmp_path / name)))
        want = flat_tensors(t)
        assert set(back) == set(want)
        for k in want:
            assert back[k].dtype == want[k].dtype and torch.equal(back[k], want[k]), k


def test_run_resumes_exactly_from_a_directory(tmp_path):
    """``run`` over 4 batches equals 2 steps, ``save_state``, a fresh
    trainer's ``restore_state`` and the last 2 steps, bit for bit."""
    cfg = get_arch("tiny_v2")
    params = unity_params_from_jax(jax.tree.map(np.asarray, junity.unity_init(
        jax.random.PRNGKey(3), jget_arch("tiny_v2"))))
    ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, weight_decay=0.01,
                        max_epochs=1, eval_steps=100, float_dtype=torch.float32)
    batches = _batches(4, seed=7)
    whole = UnitYFinetune(params, cfg, ft, train_data=batches, device="cpu")
    assert whole.run() == 4
    first = UnitYFinetune(params, cfg, ft, train_data=batches[:2], device="cpu")
    assert first.run() == 2
    first.save_state(str(tmp_path / "state"), step_nr=2)
    second = UnitYFinetune(params, cfg, ft, train_data=batches[2:], device="cpu")
    assert second.run(start_step=second.restore_state(str(tmp_path / "state"))) == 4
    assert first.step_losses + second.step_losses == whole.step_losses
    for (_, a), (_, b) in zip(named_leaves(whole.params), named_leaves(second.params)):
        assert torch.equal(a, b)


def test_offload_dots_gradients_equal_dots():
    """One S2T loss and backward (tiny_v2) under ``remat_layers("dots")``
    and ``("offload_dots")``: every gradient bit for bit."""
    from seamless_communication_torch.ops.remat import remat_layers

    cfg = get_arch("tiny_v2")
    params = unity_params_from_jax(jax.tree.map(np.asarray, junity.unity_init(
        jax.random.PRNGKey(4), jget_arch("tiny_v2"))))
    batch = batch_to(_batches(1, seed=2)[0], torch.device("cpu"))
    grads = {}
    for policy in ("dots", "offload_dots"):
        p = trainable_copy(params, torch.device("cpu"))
        with remat_layers(policy):
            loss, n = ttrainer.s2t_loss(p, cfg, batch)
            (loss / n).backward()
        grads[policy] = [t.grad for _, t in named_leaves(p) if t.grad is not None]
    assert len(grads["dots"]) == len(grads["offload_dots"]) > 100
    assert all(torch.equal(a, b) for a, b in zip(grads["dots"], grads["offload_dots"]))
