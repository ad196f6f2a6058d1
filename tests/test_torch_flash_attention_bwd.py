"""The backward of the fused-attention option (kernels K6b and K6c): the
port's plain backward ``_reference_bwd`` against the library's
``mha_reference_bwd``, the gradients of the port's ``try_flash`` against
``jax.vjp`` of JAX's plain ``_sdpa`` and, on one small case, of JAX's
``try_flash`` with the library's Pallas kernels and ``custom_vjp`` in
interpret mode (``pallas_interpret``), all on the same numpy inputs.

Cases are those of ``tests/test_torch_flash_attention.py``. Tolerances:
fp32 1e-5 * (1 + |ref|); bf16 2e-2 * (1 + |ref|) (8 bits of mantissa, and
the port rounds p and dS to bf16 where ``mha_reference_bwd`` keeps fp32, so
only fp32 pins the arithmetic there; the interpret-mode case pins the
padding contract and, in bf16, the casts). The CUDA kernels against the plain backward run only
where there is a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from seamless_communication_tpu.ops import attention as jattn
from seamless_communication_tpu.ops import fused_attention as jfa

from seamless_communication_torch.ops import fused_attention as tfa
from seamless_communication_torch.ops.kernels import flash_attention as tfl
from seamless_communication_torch.ops.kernels import launch_counts

from tests.test_torch_flash_attention import CASES, _inputs, pallas_interpret

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _kernel_inputs(case: str):
    """numpy (qs, k, v, ab, q_seg, kv_seg, do) as ``try_flash`` hands them to
    the kernel: q pre-scaled, a pure key-padding bias as segment ids, any
    other bias and the extra logits folded into ``ab``."""
    q, k, v, bias, extra, scale = _inputs(case)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    ab = q_seg = kv_seg = None
    if bias is not None and extra is None and bias.shape[1] == bias.shape[2] == 1:
        kv_seg = (bias[:, 0, 0, :] > -1e8).astype(np.int32)
        q_seg = np.ones((B, Tq), np.int32)
    elif bias is not None or extra is not None:
        ab = sum(x for x in (extra, bias) if x is not None)
        ab = np.broadcast_to(ab, (B, H, Tq, Tk)).astype(np.float32)
    do = np.random.default_rng(100 + sorted(CASES).index(case)).standard_normal(
        (B, H, Tq, Dh)).astype(np.float32)
    return (q * scale).astype(np.float32), k, v, ab, q_seg, kv_seg, do


def _tt(x, dtype=None):
    if x is None:
        return None
    t = torch.as_tensor(np.array(x))
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def _assert_close(got, want, tol, what):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    bad = err > tol * (1 + np.abs(want))
    assert not bad.any(), f"{what}: max err {err.max():.3g} over {tol} * (1 + |ref|)"


@pytest.fixture
def fused_on(monkeypatch):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_reference_bwd_matches_library_reference(case, dtype):
    """``_reference_bwd`` against the library's ``mha_reference_bwd`` fed the
    library reference forward's ``o``, ``l`` and ``m`` (computed in fp32,
    as K6 keeps them)."""
    jdt, tdt, tol = DTYPES[dtype]
    qs, k, v, ab, q_seg, kv_seg, do = _kernel_inputs(case)
    seg = None if q_seg is None else lib.SegmentIds(q=jnp.asarray(q_seg),
                                                      kv=jnp.asarray(kv_seg))
    j = lambda x: None if x is None else jnp.asarray(x, jdt)
    o, l, m = lib.mha_reference_no_custom_vjp(
        jnp.asarray(j(qs), jnp.float32), jnp.asarray(j(k), jnp.float32),
        jnp.asarray(j(v), jnp.float32),
        None if ab is None else jnp.asarray(j(ab), jnp.float32), seg,
        save_residuals=True)
    want = lib.mha_reference_bwd(j(qs), j(k), j(v), j(ab), seg, o.astype(jdt), l, m,
                                 j(do))
    got = tfl._reference_bwd(_tt(qs, tdt), _tt(k, tdt), _tt(v, tdt), _tt(ab, tdt),
                             _tt(q_seg), _tt(kv_seg), _tt(np.asarray(o.astype(jdt)
                                                                    .astype(jnp.float32)), tdt),
                             _tt(np.asarray(m)), _tt(np.asarray(l)), _tt(do, tdt))
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == tdt
        _assert_close(g, np.asarray(jnp.asarray(w, jnp.float32)), tol, name)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_bwd_parts_are_the_whole(case):
    """``_reference_bwd(part="dkv")`` (K6b's function) gives the whole
    backward's dk and dv, ``part="dq"`` (K6c's) its dq and dab, each with
    the other results None."""
    qs, k, v, ab, q_seg, kv_seg, do = (_tt(x) for x in _kernel_inputs(case))
    out, m, l = tfl._reference_fwd(qs, k, v, ab, q_seg, kv_seg)
    args = (qs, k, v, ab, q_seg, kv_seg, out, m, l, do)
    dq, dk, dv, dab = tfl._reference_bwd(*args)
    dkv = tfl._reference_bwd(*args, part="dkv")
    assert dkv[0] is None and dkv[3] is None
    assert torch.equal(dkv[1], dk) and torch.equal(dkv[2], dv)
    dq_part = tfl._reference_bwd(*args, part="dq")
    assert dq_part[1] is None and dq_part[2] is None
    assert torch.equal(dq_part[0], dq)
    assert (dab is None and dq_part[3] is None) or torch.equal(dq_part[3], dab)


def _jax_sdpa_grads(case):
    """q, k, v and extra_logits gradients of JAX's plain ``_sdpa`` (the
    fused option off) for the seeded output gradient."""
    q, k, v, bias, extra, scale = _inputs(case)
    do = _kernel_inputs(case)[-1]
    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)]
    if extra is not None:
        args.append(jnp.asarray(extra))

    def f(q, k, v, extra=None):
        return jattn._sdpa(q, k, v, None if bias is None else jnp.asarray(bias),
                           extra_logits=extra, scale=scale)

    out, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_try_flash_grads(case):
    q, k, v, bias, extra, scale = _inputs(case)
    do = _kernel_inputs(case)[-1]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    if extra is not None:
        leaves.append(torch.tensor(extra, requires_grad=True))
    out = tfa.try_flash(*leaves[:3], _tt(bias), leaves[3] if extra is not None else None,
                        scale)
    assert out.grad_fn is not None
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.as_tensor(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_try_flash_grads_match_jax_sdpa(fused_on, case):
    """Through the port's ``FlashAttention`` (plain versions on the CPU) the
    gradients of q, k, v and the extra logits are those of JAX's plain
    attention, fp32 within 1e-5 * (1 + |ref|)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAMLESS_FUSED_ATTN", "0")
        want = _jax_sdpa_grads(case)
    got = _torch_try_flash_grads(case)
    assert len(got) == len(want)
    for name, g, w in zip(("dq", "dk", "dv", "d_extra"), got, want):
        _assert_close(g, w, 1e-5, f"{case} {name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_try_flash_grads_match_jax_library_kernel(fused_on, dtype):
    """One small case against ``jax.vjp`` of JAX's ``try_flash`` with the
    option on: the library's forward, dkv and dq Pallas kernels and its
    ``custom_vjp``, in interpret mode, with Tq = Tk = 130 padded to 256 and
    the padded keys segment-masked (B=1, H=1, Dh=16, Shaw-like relative
    logits plus key padding). This pins the padding and dS contract, and in
    bf16 the casts of p and dS."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    T, Dh, scale = 130, 16, 0.25
    q, k, v = (rng.standard_normal((1, 1, T, Dh)).astype(np.float32) for _ in range(3))
    extra = (rng.standard_normal((1, 1, T, T)) * 0.5).astype(np.float32)
    bias = np.where(np.arange(T) < 121, 0.0, -1e9).astype(np.float32)[None, None, None]
    do = rng.standard_normal((1, 1, T, Dh)).astype(np.float32)

    def f(q, k, v, extra):
        return jfa.try_flash(q, k, v, jnp.asarray(bias), extra, scale)

    with pallas_interpret():
        out, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)),
                           jnp.asarray(extra))
        want = [np.asarray(jnp.asarray(g, jnp.float32))
                for g in vjp(jnp.asarray(do, jdt))]
    leaves = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    leaves.append(torch.tensor(extra, requires_grad=True))
    got_out = tfa.try_flash(*leaves[:3], torch.as_tensor(bias), leaves[3], scale)
    _assert_close(got_out.detach(), np.asarray(jnp.asarray(out, jnp.float32)), tol, "out")
    got = torch.autograd.grad(got_out, leaves, torch.as_tensor(do).to(tdt))
    for name, g, w in zip(("dq", "dk", "dv", "d_extra"), got, want):
        _assert_close(g, w, tol, name)


def test_autograd_only_where_needed(fused_on):
    """``flash_attention`` goes through ``FlashAttention`` (and keeps the
    residuals) only where autograd records: not under
    ``torch.inference_mode`` nor ``torch.no_grad``, nor for inputs that
    require no grad; the output is the same either way. Segment ids get no
    gradient, and ``ab`` one only where it requires it."""
    qs, k, v, ab, q_seg, kv_seg, do = _kernel_inputs("shaw_extra_padding")
    qs, k, v = (torch.tensor(x, requires_grad=True) for x in (qs, k, v))
    ab = torch.as_tensor(ab)
    out = tfl.flash_attention(qs, k, v, ab)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            plain = tfl.flash_attention(qs, k, v, ab)
        assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert tfl.flash_attention(qs.detach(), k.detach(), v.detach(), ab).grad_fn is None
    dq, dk, dv = torch.autograd.grad(out, (qs, k, v), torch.as_tensor(do))
    assert dq.shape == qs.shape and dv.shape == v.shape
    q2 = torch.tensor(_kernel_inputs("key_padding")[0], requires_grad=True)
    segs = [torch.as_tensor(x) for x in _kernel_inputs("key_padding")[4:6]]
    kk = torch.as_tensor(_kernel_inputs("key_padding")[1])
    out2 = tfl.flash_attention(q2, kk, kk, None, *segs)
    (g,) = torch.autograd.grad(out2.sum(), (q2,))
    assert torch.isfinite(g).all()


def test_translator_inference_runs_with_option_on(monkeypatch):
    """The Translator's ``inference_mode`` path with the option on: a tiny
    S2TT of 3 s (192 conformer frames, so the encoder takes the fused path)
    gives the tokens it gives with the option off, and no backward kernel is
    counted."""
    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel
    from tests.test_torch_translator_s2st import LANGS, TEXT_SPM

    cfg = get_arch("tiny_v2")
    params = unity.unity_init(torch.Generator().manual_seed(0), cfg)
    tok = NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS)
    tr = Translator(params, cfg, tok, device="cpu")
    wav = (np.random.default_rng(3).standard_normal(3 * 16000) * 0.1).astype(np.float32)
    opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 10))
    tokens = {}
    before = dict(launch_counts)
    for mode in ("1", "0"):
        monkeypatch.setenv("SEAMLESS_FUSED_ATTN", mode)
        tr.predict(wav, "s2tt", "eng", text_generation_opts=opts)
        tokens[mode] = tr.generator.last_result.tokens.tolist()
    assert tokens["1"] == tokens["0"]
    assert launch_counts == before


def test_bound_bwd_counts_the_backward():
    """At the 10 s Shaw shape (B=1, H=16, T=512, 499 valid keys, Dh=64, with
    ab): 10*Dh flops a pair, 2.6 GFLOP, 39 us at the fp32 rate (operations);
    in bf16 about 25 MB of bytes, 7.5 us. K6b's part counts 8*Dh, K6c's
    6*Dh."""
    pairs = 16 * 512 * 499
    ms, by = tfl.bound_bwd(1, 16, 512, 512, 64, torch.float32, True, False, pairs)
    assert by == "operations" and abs(ms - 10 * 64 * pairs / 67e12 * 1e3) < 1e-12
    ms, by = tfl.bound_bwd(1, 16, 512, 512, 64, torch.bfloat16, True, False, pairs)
    rows, keys = 16 * 512 * 64, 16 * 512 * 64
    nbytes = (4 * rows + 4 * keys) * 2 + 8 * 16 * 512 + 2 * 16 * 512 * 512 * 2
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    assert abs(ms - 7.5e-3) < 0.1e-3
    dkv, _ = tfl.bound_bwd(1, 16, 512, 512, 64, torch.float32, True, False, pairs,
                           part="dkv")
    dq, _ = tfl.bound_bwd(1, 16, 512, 512, 64, torch.float32, True, False, pairs,
                          part="dq")
    assert abs(dkv - 8 * 64 * pairs / 67e12 * 1e3) < 1e-12
    assert abs(dq - 6 * 64 * pairs / 67e12 * 1e3) < 1e-12


SKIP_CASES = {
    # rows 0-63 in segment 1, 64-127 in 2, 128-129 in 9, which no key has
    # (all their keys masked); keys 0-63 in 1, 64-127 in 2, 128-199 in 3;
    # a random ab
    "segments": ([[False, True, True, True], [True, False, True, True],
                  [False, False, False, False]]),
    # the NAR T2U's FFT layers: every row in segment 1, keys past 70
    # padding (segment 0), no ab
    "key padding": [[False, False, True, True]] * 3,
}


def _skip_inputs(case: str):
    """torch fp32 (qs, k, v, ab, q_seg, kv_seg, do) of a ``SKIP_CASES``
    entry: B=1, H=2, Tq=130, Tk=200, Dh=16."""
    rng = np.random.default_rng(31 + list(SKIP_CASES).index(case))
    B, H, Tq, Tk, Dh = 1, 2, 130, 200, 16
    qs = rng.standard_normal((B, H, Tq, Dh)).astype(np.float32) * 0.25
    k, v = (rng.standard_normal((B, H, Tk, Dh)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, H, Tq, Dh)).astype(np.float32)
    if case == "segments":
        q_seg = np.repeat([1, 2, 9], [64, 64, 2])[None]
        kv_seg = np.repeat([1, 2, 3], [64, 64, 72])[None]
        ab = (rng.standard_normal((B, H, Tq, Tk)) * 0.5).astype(np.float32)
    else:
        q_seg = np.ones((B, Tq))
        kv_seg = (np.arange(Tk) < 70)[None]
        ab = None
    return tuple(_tt(x) for x in (qs, k, v, ab, q_seg.astype(np.int32),
                                  kv_seg.astype(np.int32), do))


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skip_rule_marks_the_masked_tiles(case):
    """``skippable_tiles`` (the predicate of bf16 K6c) skips a (row tile, key
    tile) pair only where every key of the tile is masked for every row of
    the tile and each row has an unmasked key: the all-masked rows of
    segment 9 (m at the mask level) take every key tile."""
    qs, k, v, ab, q_seg, kv_seg, do = _skip_inputs(case)
    _, m, _ = tfl._reference_fwd(qs, k, v, ab, q_seg, kv_seg)
    skip = tfl.skippable_tiles(m, q_seg, kv_seg, k.shape[2])
    want = torch.tensor(SKIP_CASES[case])
    assert skip.shape == (1, 2, 3, 4)
    assert torch.equal(skip[0, 0], want) and torch.equal(skip[0, 1], want)
    assert not tfl.skippable_tiles(m, None, None, k.shape[2]).any()
    if case == "segments":
        assert bool((m[0, :, 128:] <= tfl.MASK_VALUE / 2).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skipped_tiles_change_no_bit(case, dtype):
    """For each row tile, ``_reference_bwd(part="dq")`` with the keys of its
    skipped tiles dropped gives the tile's rows of dq bit for bit as the
    full backward does, whose dab is exactly 0 on the skipped pairs: leaving
    those tiles out, as bf16 K6c does, changes nothing."""
    _, tdt, _ = DTYPES[dtype]
    qs, k, v, ab, q_seg, kv_seg, do = (
        x if x is None or not x.is_floating_point() else x.to(tdt) for x in _skip_inputs(case))
    out, m, l = tfl._reference_fwd(qs, k, v, ab, q_seg, kv_seg)
    dq, _, _, dab = tfl._reference_bwd(qs, k, v, ab, q_seg, kv_seg, out, m, l, do, part="dq")
    skip = tfl.skippable_tiles(m, q_seg, kv_seg, k.shape[2])
    Tq, Tk = qs.shape[2], k.shape[2]
    for h in range(qs.shape[1]):
        for rt in range(skip.shape[2]):
            rows = slice(64 * rt, min(64 * rt + 64, Tq))
            keep = torch.tensor([j for j in range(Tk) if not skip[0, h, rt, j // 64]])
            drop = torch.tensor([j for j in range(Tk) if skip[0, h, rt, j // 64]],
                                dtype=torch.long)
            part = tfl._reference_bwd(
                qs, k[:, :, keep], v[:, :, keep], None if ab is None else ab[..., keep],
                q_seg, kv_seg[:, keep], out, m, l, do, part="dq")[0]
            assert torch.equal(part[0, h, rows], dq[0, h, rows]), (h, rt)
            if dab is not None and len(drop):
                assert not dab[0, h, rows][:, drop].any()


def _fft_masked_inputs():
    """numpy (qs, k, v, None, q_seg, kv_seg, do) like the NAR T2U's FFT
    layers (B=1, H=4, T=1024, Dh=64, 318 valid keys as segment ids), with
    rows 900-963 in a segment no key has: all their keys are masked, so
    their row tiles may not be skipped."""
    rng = np.random.default_rng(41)
    B, H, T, Dh = 1, 4, 1024, 64
    qs, k, v, do = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4))
    q_seg = np.ones((B, T), np.int32)
    q_seg[:, 900:964] = 7
    kv_seg = (np.arange(T) < 318).astype(np.int32)[None]
    return qs / 8, k, v, None, q_seg, kv_seg, do


def _fft_3g_inputs():
    """numpy (qs, k, v, None, q_seg, kv_seg, do) at the attention shape of
    phase 3g's S2S train steps in the NAR T2U's FFT layers (B=2, H=16,
    T=1136, Dh=64; 1136 and 850 valid keys as segment ids): the key tiles
    past the second row's 850 keys are skipped for it."""
    rng = np.random.default_rng(43)
    B, H, T, Dh = 2, 16, 1136, 64
    qs, k, v, do = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4))
    q_seg = np.ones((B, T), np.int32)
    kv_seg = (np.arange(T)[None] < np.array([[1136], [850]])).astype(np.int32)
    return qs / 8, k, v, None, q_seg, kv_seg, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES) + ["fft all-masked rows", "3g fft segments"])
def test_kernels_match_plain_backward_on_card(case, dtype):
    """K6b and K6c on the card against ``_reference_bwd`` on the same inputs
    and the same residuals (K6's own): fp32 within 1e-4 * (1 + |ref|); bf16,
    where the kernels round p and dS where the plain backward does, each
    element within one bf16 ulp (2^-7 * |ref| + 1e-5 * max |ref|) and the
    whole within ||err|| <= 2^-9 * ||ref||, so a rounding point missed (about
    0.4 % on most elements) fails; one launch of each. The FFT-like case has
    key tiles that K6c and fp32 K6b skip and rows whose keys are all masked;
    the 3g FFT case has the skipped tiles of a train step's batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tdt, _ = DTYPES[dtype]
    dev = torch.device("cuda")
    inputs = {"fft all-masked rows": _fft_masked_inputs,
              "3g fft segments": _fft_3g_inputs}.get(case, lambda: _kernel_inputs(case))()
    qs, k, v, ab, q_seg, kv_seg, do = (
        None if x is None else _tt(x, tdt).to(dev) for x in inputs)
    if ab is not None:      # in rows padded to 16 bytes, as try_flash makes it
        ab = tfl.empty_bias(*ab.shape, ab.dtype, dev).copy_(ab)
    out, m, l = tfl._launch(qs, k, v, ab, q_seg, kv_seg, residuals=True)
    if case in ("fft all-masked rows", "3g fft segments"):
        assert tfl.skippable_tiles(m, q_seg, kv_seg, k.shape[2]).any()
    before = dict(launch_counts)
    got = tfl.flash_attention_bwd(qs, k, v, ab, q_seg, kv_seg, out, m, l, do)
    assert launch_counts["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert launch_counts["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    want = tfl._reference_bwd(qs, k, v, ab, q_seg, kv_seg, out, m, l, do)
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            assert g is None
            continue
        want_np = w.float().cpu().numpy()
        if dtype == "float32":
            _assert_close(g.cpu(), want_np, 1e-4, name)
            continue
        err = np.abs(g.float().cpu().numpy() - want_np)
        ref = np.abs(want_np)
        assert (err <= 2.0 ** -7 * ref + 1e-5 * ref.max()).all(), \
            f"{name}: max err {err.max():.3g} over one bf16 ulp"
        assert np.linalg.norm(err) <= 2.0 ** -9 * np.linalg.norm(ref), \
            f"{name}: ||err|| {np.linalg.norm(err):.3g} of ||ref|| {np.linalg.norm(ref):.3g}"
