"""The port's fused int8 vocabulary projection + top-k + logsumexp against the
JAX package, on the shapes of tests/unit/test_vocab_topk.py (N=5, D=32,
V=1000 so the last 128-row tile is padded, k=11): the port's ``_reference``
and its two wrappers on CPU tensors against JAX ``_reference`` and against
the Pallas kernels run in interpret mode (tiles of 128 and 256), with the
tiled-table tie case and N=1. What K3a's first launch writes (the lists and
stats of ``tile_bounds``) is held to the TPU kernel's own per-tile outputs.
The selection step, which runs after the first launch on the card (the
second kernel of K3a and K3b), is held to the same results here on the
plain version of what the first launch writes. Ids exactly equal; values
within rtol = atol = 1e-5 and logz within rtol 1e-5 (fp32 sums in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels import vocab_topk as jvt
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.kernels import vocab_topk as tvt

N, D, V, K = 5, 32, 1000, 11


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    table = rng.integers(-127, 128, (V, D)).astype(np.int8)
    scale = (rng.random(V) * 0.01 + 0.001).astype(np.float32)
    return dict(x=rng.standard_normal((N, D)).astype(np.float32), table=table,
                scale=scale,
                # repeated rows: equal logits that must go to the lowest id
                tie_table=np.tile(table[:100], (10, 1)), tie_scale=np.tile(scale[:100], 10))


def _inputs(d, case, lib):
    x = d["x"][:1] if case == "n1" else d["x"]
    t, s = ((d["tie_table"], d["tie_scale"]) if case == "ties"
            else (d["table"], d["scale"]))
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return conv(np.ascontiguousarray(x)), conv(t), conv(s)


def _assert_same(got, want):
    gv, gi, gz = (np.asarray(a) for a in got)
    wv, wi, wz = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int32
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gz, wz, rtol=1e-5)


@pytest.mark.parametrize("case", ["random", "ties", "n1"])
def test_reference_matches_jax(data, case):
    got = tvt._reference(*_inputs(data, case, "torch"), K)
    _assert_same(got, jvt._reference(*_inputs(data, case, "jax"), K))


def test_reference_bf16_matches_jax(data):
    """bf16 x: the int8 table widens exactly, products accumulate in fp32."""
    x, t, s = _inputs(data, "random", "torch")
    got = tvt._reference(x.to(torch.bfloat16), t, s, K)
    jx, jt, js = _inputs(data, "random", "jax")
    _assert_same(got, jvt._reference(jx.astype(jnp.bfloat16), jt, js, K))


@pytest.mark.parametrize("case,tile", [("random", 128), ("random", 256), ("ties", 128),
                                       ("n1", 128)])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_wrappers_match_pallas_interpret(data, version, case, tile):
    jfn, tfn = ((jvt.int8_vocab_topk, tvt.int8_vocab_topk) if version == "v1"
                else (jvt.int8_vocab_topk_v2, tvt.int8_vocab_topk_v2))
    want = jfn(*_inputs(data, case, "jax"), K, use_pallas=True, tile=tile,
               interpret=True)
    kw = {"tile": tile} if version == "v1" else {}
    _assert_same(tfn(*_inputs(data, case, "torch"), K, **kw), want)


@pytest.mark.parametrize("case", ["random", "ties", "n1"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_combine_steps_match_jax(data, version, case):
    """What the first launch writes, as the plain version computes it, through
    the selection step equals JAX ``_reference``: v1, K3a's per-tile lists and
    stats over ``tile_bounds`` (128-row tiles, the last cut at V); v2, K3b's
    per-block lists and stats over 3 blocks of ``stream_bounds`` (ranges of
    uneven tile counts); then the plain version of their second launch.
    Covers the tie-break across tiles and blocks and the short last tile."""
    args = _inputs(data, case, "torch")
    bounds = tvt.tile_bounds(V, tvt.TILE) if version == "v1" else tvt.stream_bounds(V, 3)
    vals, ids, m, se = tvt._tiles_reference(*args, K, bounds)
    G = 8 if version == "v1" else 3
    assert vals.shape == ids.shape == (G, args[0].shape[0], K) and m.shape == (G, args[0].shape[0])
    if version == "v1":
        assert bool((ids[-1] >= 896).all())
    assert bool((ids < V).all())
    got = tvt._select_reference(vals, ids, m, se, K)
    _assert_same(got, jvt._reference(*_inputs(data, case, "jax"), K))


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("G", [1, 2, 5, 8])
def test_stream_partitions_match_jax(data, G, case):
    """K3b's two plain versions over G stream blocks (``stream_bounds``: each
    block a run of whole 128-row tiles, together every row once) equal JAX
    ``_reference``; each block's list is sorted by value, then id, and
    holds only ids of its own rows."""
    bounds = tvt.stream_bounds(V, G)
    assert bounds[0] == 0 and bounds[-1] == V
    assert all(lo < hi and lo % tvt.TILE == 0 for lo, hi in zip(bounds[:-1], bounds[1:]))
    args = _inputs(data, case, "torch")
    vals, ids, m, se = tvt._tiles_reference(*args, K, bounds)
    for g, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        assert bool(((ids[g] >= lo) & (ids[g] < hi)).all())
        v, i = vals[g], ids[g].long()
        assert bool(((v[:, :-1] > v[:, 1:]) | ((v[:, :-1] == v[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all())
    _assert_same(tvt._select_reference(vals, ids, m, se, K),
                 jvt._reference(*_inputs(data, case, "jax"), K))


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("tile", [128, 256, 384, 1024])
def test_tile_partitions_match_jax(data, tile, case):
    """K3a's tiles (``tile_bounds``: [0, tile, 2 tile, ..., V]) hold every
    row in exactly one tile; each tile's list holds only its own ids, and
    the lists through ``_select_reference`` equal JAX ``_reference``."""
    bounds = tvt.tile_bounds(V, tile)
    assert bounds[0] == 0 and bounds[-1] == V and len(bounds) - 1 == -(-V // tile)
    owner = np.zeros(V, np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        assert lo % tile == 0 and (hi - lo == tile or hi == V)
        owner[lo:hi] += 1
    assert (owner == 1).all()
    args = _inputs(data, case, "torch")
    vals, ids, m, se = tvt._tiles_reference(*args, K, bounds)
    for g, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        assert bool(((ids[g] >= lo) & (ids[g] < hi)).all())
    _assert_same(tvt._select_reference(vals, ids, m, se, K),
                 jvt._reference(*_inputs(data, case, "jax"), K))


@pytest.mark.parametrize("case", ["random", "ties", "short last tile"])
@pytest.mark.parametrize("tile", [128, 256])
def test_tile_lists_match_pallas_kernel(data, tile, case):
    """What K3a's first launch writes, as its plain version computes it
    (``_tiles_reference`` over ``tile_bounds``), against the TPU kernel's
    own outputs (``_pallas_call`` in interpret mode): the same values, ids,
    maxima and Σexp on every tile, except the entries past the rows of a
    tile with fewer than k rows below V, which each side pads its own way:
    the port with (-inf, ``NO_ID``), the TPU kernel with NEG and an id it
    took already (the tile's lowest: every row left is NEG then).
    "short last tile" cuts the table to V = 773, whose last tile (of 128 or
    256 rows) holds 5 rows."""
    x, t, s = _inputs(data, "ties" if case == "ties" else "random", "torch")
    if case == "short last tile":
        t, s = t[:773], s[:773]
    Vc = t.shape[0]
    vals, ids, m, se = tvt._tiles_reference(x, t, s, K, tvt.tile_bounds(Vc, tile))
    jv, ji, jm, jse = (np.asarray(a) for a in jvt._pallas_call(
        jnp.asarray(x.numpy()), jnp.asarray(t.numpy()), jnp.asarray(s.numpy()), k=K,
        tile=tile, interpret=True))
    G = -(-Vc // tile)
    assert jv.shape == tuple(vals.shape) == (G, x.shape[0], K)
    rows = np.minimum(Vc - tile * np.arange(G), tile)        # each tile's rows below V
    real = np.arange(K)[None, None, :] < rows[:, None, None]
    real = np.broadcast_to(real, jv.shape)
    np.testing.assert_array_equal(ids.numpy()[real], ji[real])
    np.testing.assert_allclose(vals.numpy()[real], jv[real], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), jm[..., 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(se.numpy(), jse[..., 0], rtol=1e-5)
    pad = ~real
    assert pad.any() == (case == "short last tile")
    assert bool(np.isneginf(vals.numpy()[pad]).all()) and (ids.numpy()[pad] == tvt.NO_ID).all()
    lowest = np.broadcast_to((tile * np.arange(G))[:, None, None], ji.shape)
    assert (jv[pad] == np.float32(jvt.NEG)).all() and (ji[pad] == lowest[pad]).all()


def test_fill_tile_gives_each_block_one_tile():
    """K3a's default tile: the least multiple of 128 of which at most G tiles
    cover V (the stream's grid: 264 blocks at N = 5, 132 at N = 10 on 132
    SMs), so that each block's range is one K3a tile."""
    assert tvt.fill_tile(256102, 264) == 1024 and tvt.fill_tile(256102, 132) == 2048
    for V_, G in ((256102, 264), (256102, 132), (1000, 3), (1000, 8), (1000, 1024),
                  (773, 5)):
        tile = tvt.fill_tile(V_, G)
        assert tile % tvt.TILE == 0 and -(-V_ // tile) <= G
        assert tile == tvt.TILE or -(-V_ // (tile - tvt.TILE)) > G


def test_check_takes_tiles_of_whole_stream_tiles(data):
    """K3a's tile is a multiple of 128 with at most ``MAX_LISTS`` tiles, and
    k at most min(V, ``MAX_K``, tile); ``_check`` raises otherwise."""
    args = _inputs(data, "random", "torch")
    for tile in (128, 256, 1024, 4096):
        tvt._check(tvt.KERNEL_V1, *args, K, tile)
    for tile, k, match in ((100, K, "multiple of 128"), (192, K, "multiple of 128"),
                           (0, K, "multiple of 128"), (128, 129, "outside")):
        with pytest.raises(ValueError, match=match):
            tvt._check(tvt.KERNEL_V1, *args, k, tile)
    big = torch.zeros((tvt.MAX_LISTS * 128 + 1, D), dtype=torch.int8)
    with pytest.raises(ValueError, match="at most 2048 tiles"):
        tvt._check(tvt.KERNEL_V1, args[0], big, torch.ones(big.shape[0]), K, 128)
    tvt._check(tvt.KERNEL_V1, args[0], big, torch.ones(big.shape[0]), K, 256)


def test_short_ranges_pad_the_lists(data):
    """A range of fewer rows than k pads its list with (-inf, ``NO_ID``),
    which the selection never takes while k <= V."""
    args = _inputs(data, "random", "torch")
    bounds = [0, 5, 128, V]
    vals, ids, m, se = tvt._tiles_reference(*args, K, bounds)
    assert bool(torch.isinf(vals[0, :, 5:]).all()) and bool((ids[0, :, 5:] == tvt.NO_ID).all())
    _assert_same(tvt._select_reference(vals, ids, m, se, K),
                 jvt._reference(*_inputs(data, "random", "jax"), K))


def test_cpu_tensors_take_the_plain_version(data):
    before = dict(launch_counts)
    args = _inputs(data, "random", "torch")
    want = tvt._reference(*args, K)
    for fn in (tvt.int8_vocab_topk, tvt.int8_vocab_topk_v2):
        for g, w in zip(fn(*args, K), want):
            assert torch.equal(g, w)
    assert launch_counts == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tvt.int8_vocab_topk_v2(*(a.to("meta") for a in args), K)


def test_bound_bytes_counts_each_byte_once():
    # the int8 table, row scales and x read once; top-k values, ids and logz
    # written once; nothing a kernel writes between its launch and the
    # selection
    for elem in (4, 2):
        assert tvt.bound_bytes(N=5, D=1024, V=256102, k=11, elem=elem) == (
            256102 * 1024 + 4 * 256102 + elem * 5 * 1024 + 5 * 11 * 8 + 4 * 5)


@pytest.mark.parametrize("case", ["random", "ties", "n1"])
def test_float_vocab_topk_matches_jax(data, case):
    """The candidate step over an unquantized table: JAX ``_reference`` with
    unit row scales, as its ``text_decoder_step_topk`` calls it."""
    x, t, _ = _inputs(data, case, "torch")
    w = t.float() * 0.01
    got = tvt.float_vocab_topk(x, w, K)
    jx, jt, _ = _inputs(data, case, "jax")
    jw = jt.astype(jnp.float32) * 0.01
    _assert_same(got, jvt._reference(jx, jw, jnp.ones((jw.shape[0],), jnp.float32), K))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k11", "k128 repeated rows"])
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("n", [5, 10])
def test_kernel_matches_plain_version_on_card(version, n, case):
    """Each CUDA kernel against its plain version at V=256102, D=1024: k=11
    on a random table, and k=128 (K3b's and K3a's largest) on a table whose
    rows repeat every 1000 (equal logits across tiles and stream blocks,
    which go to the lowest id). K3b launches twice a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from seamless_communication_torch.ops.quantization import quantize_embedding

    gen = torch.Generator(device="cuda").manual_seed(0)
    table, scale = quantize_embedding(torch.randn((256102, 1024), generator=gen,
                                                  device="cuda"))
    k = 11
    if case != "k11":
        k = tvt.MAX_K
        table = table[:1000].repeat(257, 1)[:256102].contiguous()
        scale = scale[:1000].repeat(257)[:256102].contiguous()
    x = torch.randn((n, 1024), generator=gen, device="cuda")
    fn = tvt.int8_vocab_topk if version == "v1" else tvt.int8_vocab_topk_v2
    name = tvt.KERNEL_V1 if version == "v1" else tvt.KERNEL
    before = launch_counts[name]
    gv, gi, gz = fn(x, table, scale, k)
    assert launch_counts[name] - before == 2      # the stream, then the selection
    wv, wi, wz = tvt._reference(x, table, scale, k)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gz, wz, rtol=1e-5, atol=0)
    assert torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [512, 1024, 2048])
@pytest.mark.parametrize("n", [5, 10])
def test_k3a_tiles_match_plain_version_on_card(n, tile):
    """K3a at each tile chip_smoke.py times, against its plain version at
    V=256102, D=1024: k=11 on a random table and k=128 on rows repeating
    every 1000; its first launch's lists against ``_tiles_reference`` over
    ``tile_bounds`` (ids equal, values within 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from seamless_communication_torch.ops.quantization import quantize_embedding

    gen = torch.Generator(device="cuda").manual_seed(0)
    table, scale = quantize_embedding(torch.randn((256102, 1024), generator=gen,
                                                  device="cuda"))
    x = torch.randn((n, 1024), generator=gen, device="cuda")
    tie_table = table[:1000].repeat(257, 1)[:256102].contiguous()
    tie_scale = scale[:1000].repeat(257)[:256102].contiguous()
    for t, s, k in ((table, scale, 11), (tie_table, tie_scale, tvt.MAX_K)):
        gv, gi, gz = tvt.int8_vocab_topk(x, t, s, k, tile=tile)
        wv, wi, wz = tvt._reference(x, t, s, k)
        torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gz, wz, rtol=1e-5, atol=0)
        assert torch.equal(gi, wi)
    lv, li, lm, lse = tvt._launch_stream(x, table, scale, 11, tile)
    rv, ri, rm, rse = tvt._tiles_reference(x, table, scale, 11, tvt.tile_bounds(256102, tile))
    assert torch.equal(li, ri)
    torch.testing.assert_close(lv, rv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lm, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rse, rtol=1e-5, atol=0)
