"""The frozen counts against the program's own ``bound*`` arithmetic at the
cells' shapes: equal, but for the fp32 peak, whose difference is held
here."""

import pytest
import torch

import tiny  # noqa: F401  (paths)
from counts import model_flops as mf
from counts.kernels import k1_bound_s, k1_bytes, k6_bound_s
from counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from harness.common import load_json
from seamless_communication_torch.ops.kernels import decode_attention as da
from seamless_communication_torch.ops.kernels import flash_attention as fa

# K1 at the serve cell's groups (B = requests x 5 beams, T the cache length)
K1_SHAPES = [(160, 16, 128, 64, 32), (160, 16, 64, 64, 32), (40, 16, 320, 64, 8),
             (5, 16, 128, 64, 1)]
# K6 at the pool's adaptor (8 slots, the 257-frame buffer) and the serve
# encoder's shape
K6_SHAPES = [(8, 16, 257, 257, 64, False, True), (1, 16, 512, 512, 64, True, False)]


@pytest.mark.parametrize("B,H,T,Dh,n_src", K1_SHAPES)
def test_k1_bytes_equal_the_program(B, H, T, Dh, n_src):
    for elem in (4, 2):
        assert k1_bytes(B, H, T, Dh, n_src=n_src, elem=elem) == da.bound_bytes(
            B, H, T, Dh, n_src=n_src, elem=elem)
    t = k1_bound_s(B, H, T, Dh, n_src=n_src, elem=4)
    assert t == pytest.approx(da.bound_bytes(B, H, T, Dh, n_src=n_src, elem=4)
                              / HBM_BYTES_PER_S)


@pytest.mark.parametrize("B,H,Tq,Tk,Dh,ab,seg", K6_SHAPES)
def test_k6_bound_equal_but_the_fp32_peak(B, H, Tq, Tk, Dh, ab, seg):
    pairs = B * H * Tq * (Tk - 3)
    mine = k6_bound_s(B, H, Tq, Tk, Dh, "bfloat16", has_ab=ab, has_seg=seg, pairs=pairs)
    theirs, _ = fa.bound(B, H, Tq, Tk, Dh, torch.bfloat16, ab, seg, pairs=pairs)
    assert mine * 1e3 == pytest.approx(theirs)
    mine32 = k6_bound_s(B, H, Tq, Tk, Dh, "float32", has_ab=ab, has_seg=seg, pairs=pairs)
    theirs32, _ = fa.bound(B, H, Tq, Tk, Dh, torch.float32, ab, seg, pairs=pairs)
    bytes_ms, _ = fa.bound(B, H, Tq, Tk, Dh, torch.float32, ab, seg, pairs=0)
    ops = 4 * pairs * Dh
    # the program bounds fp32 operations at the SIMT rate, the benchmark at TF32's
    assert fa.PEAK_FLOPS[torch.float32] == 67e12 and PEAK_FLOPS["float32"] == 495e12
    assert theirs32 == pytest.approx(max(bytes_ms, ops / 67e12 * 1e3))
    assert mine32 * 1e3 == pytest.approx(max(bytes_ms, ops / 495e12 * 1e3))


def test_model_flops_at_the_cells_sizes():
    cfg = load_json(tiny.BENCH / "configs" / "m4t_v2_large.json")
    enc, dec = cfg["speech_encoder"], cfg["text_decoder"]
    # 10 s: 998 frames, 499 stacked rows, 63 adaptor frames
    assert mf.adaptor_len(enc, 499) == 63
    per_row = mf.conformer_rows(enc, 1, 1)
    assert 1.1e9 < per_row < 1.3e9           # 2 x ~0.6 B weights a stacked frame
    tok = mf.decoder_token(dec, 0, 63)
    assert 1.5e9 < tok < 1.8e9               # 2 x (24 x 22.5 M + 262 M vocabulary)
    assert mf.speech_encoder(enc, 998) > 499 * per_row
