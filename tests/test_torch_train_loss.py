"""The finetune losses and the learning-rate schedule: the port's
``train/loss.py`` and ``train/lr.py`` against the JAX package's on the same
numpy inputs, fp32. Loss values within 1e-6 (relative), gradients within
1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.train import loss as jloss
from seamless_communication_tpu.train.lr import myle_lr as jmyle_lr

from seamless_communication_torch.train import loss as tloss
from seamless_communication_torch.train.lr import myle_lr

PAD = 0


def _data(T: int = 8, V: int = 50, D: int = 16, seed: int = 0):
    """logits (B, T, V), features (B, T, D), an embedding (V, D) and
    targets (B, T) with pads at the end of the second row."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, T, V)).astype(np.float32) * 2
    feats = rng.standard_normal((2, T, D)).astype(np.float32)
    embed = (rng.standard_normal((V, D)) * D ** -0.5).astype(np.float32)
    targets = rng.integers(1, V, (2, T)).astype(np.int32)
    targets[1, T - 3:] = PAD
    return logits, feats, embed, targets


@pytest.mark.parametrize("ignore_prefix_size", [0, 1])
def test_label_smoothed_nll_matches_jax(ignore_prefix_size):
    logits, _, _, targets = _data()
    kw = dict(pad_idx=PAD, label_smoothing=0.2, ignore_prefix_size=ignore_prefix_size)

    def jf(x):
        loss, n = jloss.label_smoothed_nll_loss(x, jnp.asarray(targets), **kw)
        return loss, n

    (jl, jn), jvjp = jax.vjp(jf, jnp.asarray(logits))
    (jg,) = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    x = torch.tensor(logits, requires_grad=True)
    tl, tn = tloss.label_smoothed_nll_loss(x, torch.as_tensor(targets), **kw)
    (tg,) = torch.autograd.grad(tl, (x,))
    assert float(tn) == float(jn) == 2 * 8 - 3 - 2 * ignore_prefix_size
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [3, 4, 32])
def test_chunked_tied_nll_matches_jax(chunk):
    """Chunks of 3 against T = 8 take the pad path; 4 divides T; 32 is one
    padded chunk. Value and the gradients of the features and the table."""
    _, feats, embed, targets = _data()
    kw = dict(pad_idx=PAD, label_smoothing=0.2, ignore_prefix_size=1, chunk=chunk)

    def jf(f, e):
        loss, _ = jloss.chunked_tied_nll_loss(f, {"embedding": e}, jnp.asarray(targets),
                                              **kw)
        return loss

    jl, (jgf, jge) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(feats),
                                                             jnp.asarray(embed))
    f = torch.tensor(feats, requires_grad=True)
    e = torch.tensor(embed, requires_grad=True)
    tl, tn = tloss.chunked_tied_nll_loss(f, {"embedding": e}, torch.as_tensor(targets),
                                         **kw)
    gf, ge = torch.autograd.grad(tl, (f, e))
    assert float(tn) == 2 * 8 - 3 - 2
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-5)


def test_chunked_equals_full_logits():
    """The chunked loss is the loss of the whole logits, value and
    gradients (the port alone)."""
    _, feats, embed, targets = _data(T=11)
    kw = dict(pad_idx=PAD, label_smoothing=0.2, ignore_prefix_size=1)
    f = torch.tensor(feats, requires_grad=True)
    e = torch.tensor(embed, requires_grad=True)
    full, n_full = tloss.label_smoothed_nll_loss(f @ e.T, torch.as_tensor(targets), **kw)
    g_full = torch.autograd.grad(full, (f, e))
    chunked, n = tloss.chunked_tied_nll_loss(f, {"embedding": e}, torch.as_tensor(targets),
                                             chunk=4, **kw)
    g = torch.autograd.grad(chunked, (f, e))
    assert float(n) == float(n_full)
    np.testing.assert_allclose(float(chunked.detach()), float(full.detach()), rtol=1e-6)
    for a, b in zip(g, g_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("warmup", [1, 4, 100])
def test_myle_lr_matches_jax(warmup):
    """Step n of the schedule is optax's count n: steps 0 and 1 share a
    rate (the max(step, 1))."""
    mine, theirs = myle_lr(1e-3, warmup), jmyle_lr(1e-3, warmup)
    for step in range(12):
        np.testing.assert_allclose(mine(step), float(theirs(jnp.int32(step))), rtol=1e-6)
    assert mine(0) == mine(1)
