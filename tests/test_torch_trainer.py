"""The finetune trainer: the port's ``train/trainer.py`` against the JAX
package's on the same params (``jax.random`` init carried across by
``checkpoint/from_jax.py``) and batches, fp32, JAX at matmul precision
``highest``.

- The gradients of one ``s2t_loss`` (tiny_v2) and of ``s2st_loss`` (tiny_v2
  NAR, tiny_v1 AR): loss within 1e-5, every leaf within rtol 1e-4, atol 1e-6.
- The optimizer alone against optax's chain over 3 steps: within 1e-6.
- Two ``UnitYFinetune`` steps with the text encoder frozen and weight decay
  on: params within atol = rtol = 2e-4 (``test_sharded_s2s_train_step``'s
  tolerance), the untied text tables and the decayed frozen modules
  included.
- The port alone: remat equal to no remat, exact resume, ``run()``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.train import trainer as jtrainer
from seamless_communication_tpu.train.lr import myle_lr as jmyle_lr

from seamless_communication_torch.checkpoint.from_jax import (
    unity_params_from_jax, unity_params_to_numpy,
)
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.train import trainer as ttrainer
from seamless_communication_torch.train.trainer import (
    AdamWMyle, FinetuneMode, FinetuneParams, UnitYFinetune, batch_to, map_tree,
    named_leaves, trainable_copy,
)

from tests.integration.test_finetune import _batches, _s2s_ar_batch, _s2s_nar_batch


def _compare(got, want, rtol: float, atol: float, path: str = "") -> int:
    """Leaf by leaf; the two trees (dicts and lists) must have the same
    structure. Returns the number of leaves compared."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: {sorted(set(got) ^ set(want))}"
        return sum(_compare(got[k], want[k], rtol, atol, f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return sum(_compare(g, w, rtol, atol, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=path)
    return 1


@pytest.fixture(scope="module")
def jax_params():
    """JAX params of tiny_v2 and tiny_v1 (``unity_init``, key 1) and their
    numpy copies."""
    out = {}
    for arch in ("tiny_v2", "tiny_v1"):
        p = junity.unity_init(jax.random.PRNGKey(1), jget_arch(arch))
        out[arch] = (p, jax.tree.map(np.asarray, p))
    return out


LOSSES = {"s2t_tiny_v2": ("tiny_v2", "s2t_loss", lambda: _batches(1)[0]),
          "s2st_nar_tiny_v2": ("tiny_v2", "s2st_loss", _s2s_nar_batch),
          "s2st_ar_tiny_v1": ("tiny_v1", "s2st_loss", _s2s_ar_batch)}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_grads_match_jax(jax_params, case):
    """The loss per token and every gradient leaf of one loss against
    ``jax.value_and_grad``; leaves no loss reaches (the text encoder, and
    the T2U in S2T) have zero gradients in both."""
    arch, name, make_batch = LOSSES[case]
    jp, np_params = jax_params[arch]
    batch = make_batch()
    jfn = getattr(jtrainer, name)

    def objective(p, b):
        loss, n = jfn(p, jget_arch(arch), b)
        return loss / jnp.maximum(n, 1.0)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = trainable_copy(unity_params_from_jax(np_params), torch.device("cpu"))
    loss, n = getattr(ttrainer, name)(params, get_arch(arch),
                                      batch_to(batch, torch.device("cpu")))
    (loss / torch.clamp_min(n, 1.0)).backward()
    grads = map_tree(lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
                     params)
    np.testing.assert_allclose(float((loss / n).detach()), float(jloss), rtol=1e-5)
    n_leaves = _compare(unity_params_to_numpy(grads), jax.tree.map(np.asarray, jgrads),
                        rtol=1e-4, atol=1e-6)
    assert n_leaves == len(jax.tree.leaves(jgrads))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax(weight_decay):
    """``AdamWMyle`` fed the same gradients as ``optax.chain(
    clip_by_global_norm(1.0), adamw(myle_lr, b1=0.9, b2=0.98, eps=1e-8,
    weight_decay))``, 3 steps, gradient norms above 1 so that the clip acts
    (and one below): within 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7,), "c": (2, 3, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.05, 1.5)]
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(jmyle_lr(1e-2, 2), b1=0.9, b2=0.98, eps=1e-8,
                                    weight_decay=weight_decay))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = chain.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = AdamWMyle(list(tp.values()), 1e-2, 2, weight_decay)
    for g in grads:
        updates, state = chain.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.as_tensor(g[k]).clone()
        norm = opt.step()
        np.testing.assert_allclose(norm, float(optax.global_norm(g)), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def test_two_trainer_steps_match_jax(jax_params):
    """Two ``UnitYFinetune`` steps (S2T, the text encoder frozen, weight decay
    0.01) against JAX's: the losses within 1e-5, every parameter within
    atol = rtol = 2e-4. The port's text encoder has a table of its own, as
    JAX's tree has a leaf of its own: after the steps the decoder's table has
    moved and the encoder's has only decayed, in both; the frozen text
    encoder decayed as JAX's did."""
    jp, np_params = jax_params["tiny_v2"]
    batches = _batches(2, seed=4)
    kw = dict(finetune_mode=FinetuneMode.SPEECH_TO_TEXT, learning_rate=1e-3,
              warmup_steps=2, weight_decay=0.01, freeze_text_encoder=True)
    jft = jtrainer.FinetuneParams(**{**kw, "finetune_mode":
                                     jtrainer.FinetuneMode.SPEECH_TO_TEXT})
    jtr = jtrainer.UnitYFinetune(jp, jget_arch("tiny_v2"), jft)
    tr = UnitYFinetune(unity_params_from_jax(np_params), get_arch("tiny_v2"),
                       FinetuneParams(**kw, float_dtype=torch.float32), device="cpu")
    for batch in batches:
        jtr.params, jtr.opt_state, jm = jtr.train_step(jtr.params, jtr.opt_state, batch)
        m = tr.step(batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = jax.tree.map(np.asarray, jtr.params)
    got = unity_params_to_numpy(tr.params)
    _compare(got, want, rtol=2e-4, atol=2e-4)
    enc, dec = got["text_encoder"]["embed"]["embedding"], got["text_decoder"]["embed"]["embedding"]
    start = np_params["text_decoder"]["embed"]["embedding"]
    assert not np.allclose(enc, dec, rtol=0, atol=1e-6)
    assert not np.allclose(want["text_encoder"]["embed"]["embedding"],
                           want["text_decoder"]["embed"]["embedding"], rtol=0, atol=1e-6)
    # frozen: no gradient step, only the decay (lr * wd a step)
    np.testing.assert_allclose(enc, start * (1 - 1e-3 * 0.5 * 0.01) * (1 - 1e-3 * 0.5 * 0.01),
                               rtol=1e-6)


@pytest.fixture
def fused_on(monkeypatch):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")


def _long_batch(seed: int = 0):
    """A tiny S2T batch long enough (300 fbank frames, 150 conformer frames)
    for the conformer's attention to take the fused path."""
    b = _batches(1, seed=seed)[0]
    rng = np.random.default_rng(seed)
    b["fbank"] = rng.standard_normal((2, 300, 80)).astype(np.float32)
    b["fbank_lens"] = np.array([300, 260], np.int32)
    return b


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(fused_on, policy):
    """A step under ``remat`` ("full" recomputes each layer, K6's plain
    forward included; "dots" keeps the linears' products) gives the loss
    within 1e-5 and the params within 1e-4 of the step without."""
    cfg = get_arch("tiny_v2")
    params = unity_params_from_jax(
        jax.tree.map(np.asarray, junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))))
    batch = _long_batch()
    runs = {}
    for remat in (None, policy):
        ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, remat=remat,
                            float_dtype=torch.float32)
        tr = UnitYFinetune(params, cfg, ft, device="cpu")
        runs[remat] = (float(tr.step(batch)["loss"]), tr.params)
    assert abs(runs[None][0] - runs[policy][0]) < 1e-5
    for (_, a), (_, b) in zip(named_leaves(runs[None][1]), named_leaves(runs[policy][1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-4)


def test_remat_offload_raises():
    """``"offload_dots"`` is a policy now (its gradients are held to
    ``"dots"``'s in test_torch_parallel.py); an unknown policy raises."""
    from seamless_communication_torch.ops.remat import current_policy, remat_layers

    with remat_layers("offload_dots"):
        assert current_policy() == "offload_dots"
    assert current_policy() is None
    with pytest.raises(ValueError):
        with remat_layers("everything"):
            pass


@pytest.fixture(scope="module")
def tiny_params():
    return unity_params_from_jax(
        jax.tree.map(np.asarray, junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))))


def test_train_state_resume_exact(tiny_params, tmp_path):
    """``save_state`` after two steps, one more step; a fresh trainer that
    ``restore_state``s and takes the same step has the same params, bit for
    bit."""
    cfg = get_arch("tiny_v2")
    ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, weight_decay=0.01,
                        float_dtype=torch.float32)
    batches = _batches(3, seed=1)
    a = UnitYFinetune(tiny_params, cfg, ft, device="cpu")
    for b in batches[:2]:
        a.step(b)
    a.save_state(str(tmp_path / "state.pt"), step_nr=2)
    a.step(batches[2])
    b_tr = UnitYFinetune(tiny_params, cfg, ft, device="cpu")
    assert b_tr.restore_state(str(tmp_path / "state.pt")) == 2
    b_tr.step(batches[2])
    for (_, x), (_, y) in zip(named_leaves(a.params), named_leaves(b_tr.params)):
        assert torch.equal(x, y)


def test_run_lowers_the_loss_and_saves(tiny_params, tmp_path):
    cfg = get_arch("tiny_v2")
    ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, max_epochs=2, eval_steps=4,
                        log_steps=2, patience=2, save_model_path=str(tmp_path / "best.pt"),
                        float_dtype=torch.float32)
    batches = _batches(4)
    tr = UnitYFinetune(tiny_params, cfg, ft, train_data=batches, eval_data=batches[:1],
                       device="cpu")
    with torch.no_grad():
        first, n = ttrainer.s2t_loss(tr.params, cfg, batch_to(batches[0], tr.device))
    assert tr.run() == 8
    with torch.no_grad():
        last, _ = ttrainer.s2t_loss(tr.params, cfg, batch_to(batches[0], tr.device))
    assert float(last) < float(first)
    assert (tmp_path / "best.pt").exists()
    assert tr.best_eval < float(first / n)


def test_run_aborts_on_nan(tiny_params):
    batch = _batches(1)[0]
    batch["fbank"] = np.full_like(batch["fbank"], np.nan)
    tr = UnitYFinetune(tiny_params, get_arch("tiny_v2"),
                       FinetuneParams(learning_rate=1e-3, warmup_steps=2,
                                      float_dtype=torch.float32),
                       train_data=[batch], device="cpu")
    with pytest.raises(RuntimeError, match="NaN loss at step 0"):
        tr.run()


def test_run_stops_on_patience(tiny_params, tmp_path):
    """With a learning rate of 0 the eval loss never improves after the
    first eval, so the loop stops after ``patience`` more evals."""
    batches = _batches(2)
    ft = FinetuneParams(learning_rate=0.0, warmup_steps=2, max_epochs=10, eval_steps=2,
                        patience=2, save_model_path=str(tmp_path / "best.pt"),
                        float_dtype=torch.float32)
    tr = UnitYFinetune(tiny_params, get_arch("tiny_v2"), ft, train_data=batches,
                       eval_data=batches[:1], device="cpu")
    assert tr.run() == 2 * (1 + 2)
    assert tr.patience_left == 0


def test_float_dtype_sets_the_trained_params(tiny_params):
    """The trainer trains its copy of the params in ``ft.float_dtype``
    (bfloat16 by default): fp32 params come out bf16, the caller's stay
    fp32, the forward runs in bf16 (the loss is summed in fp32) and a step
    keeps the params bf16 with a finite loss."""
    cfg = get_arch("tiny_v2")
    batch = _batches(1)[0]
    tr = UnitYFinetune(tiny_params, cfg, FinetuneParams(learning_rate=1e-3, warmup_steps=2),
                       device="cpu")
    assert {t.dtype for _, t in named_leaves(tr.params)} == {torch.bfloat16}
    assert {t.dtype for _, t in named_leaves(tiny_params)} == {torch.float32}
    with torch.no_grad():
        feats = ttrainer._text_features(tr.params, cfg, batch_to(batch, tr.device))
    assert feats.dtype == torch.bfloat16
    assert bool(torch.isfinite(tr.step(batch)["loss"]))
    assert {t.dtype for _, t in named_leaves(tr.params)} == {torch.bfloat16}
    fp32 = UnitYFinetune(tiny_params, get_arch("tiny_v2"),
                         FinetuneParams(float_dtype=torch.float32), device="cpu")
    assert {t.dtype for _, t in named_leaves(fp32.params)} == {torch.float32}


def test_entry_points_that_raise(tiny_params):
    """A mesh larger than the process group raises (one process: one rank);
    pipeline micro-batches without a "pipe" axis are ignored, as in JAX; the
    default device is the card, which this test needs to be absent."""
    from seamless_communication_torch.parallel.sharding import make_mesh

    cfg = get_arch("tiny_v2")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(data=1, model=2)
    tr = UnitYFinetune(tiny_params, cfg, FinetuneParams(pp_microbatches=2),
                       mesh=make_mesh(), device="cpu")
    assert tr.mesh.shape == {"data": 1, "model": 1}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnitYFinetune(tiny_params, cfg, FinetuneParams())
