"""m4t_audio_to_units: speech units of one WAV file (counterpart of
``seamless_communication_tpu/cli/audio_to_units.py``; reference
cli/m4t/audio_to_units/audio_to_units.py:17-53).

    python3 -m seamless_communication_torch.cli.audio_to_units INPUT.wav \\
        --kmeans_path KMEANS.npy --w2v2_checkpoint XLSR.pt \\
        [--out_layer_number 35] [--device cuda|cpu]

The waveform is resampled to 16 kHz, encoded by the XLSR2-1B encoder
(``Wav2Vec2RawConfig()``) up to layer ``--out_layer_number`` (1-based) and
quantized by the k-means centroids (10000 x 1280). ``--w2v2_checkpoint`` is
the original ``.pt`` (fairseq1 or fairseq2 keys) or converted parameters
(``checkpoint/serialize.py``). The flags are the JAX package's, plus
``--device`` (the CUDA card unless it says ``cpu``). With
``SEAMLESS_FUSED_ATTN=1`` each layer's attention is K6 at head dim 80.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List, NamedTuple, Optional, Sequence

logger = logging.getLogger("audio_to_units")


class AudioToUnitsResult(NamedTuple):
    units: List[int]
    extractor: object          # the UnitExtractor that served the request
    timings: dict              # wall seconds: read_wav, load, build, then predict's stages


def main(argv: Optional[Sequence[str]] = None) -> AudioToUnitsResult:
    """Parse ``argv`` (``sys.argv[1:]`` when None), extract the units and
    log them. Returns the units, the extractor and the stages' seconds."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="Convert raw audio to speech units (XLSR + kmeans)")
    parser.add_argument("audio", type=str, help="WAV path")
    parser.add_argument("--kmeans_path", type=str, required=True,
                        help="kmeans centroids .npy (10k x 1280)")
    parser.add_argument("--w2v2_checkpoint", type=str, required=True,
                        help="XLSR2-1B weights: original torch .pt "
                             "(xlsr2_1b_v2.pt) or converted params")
    parser.add_argument("--out_layer_number", type=int, default=35)
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args = parser.parse_args(argv)

    from seamless_communication_torch.audio.wav import read_wav, resample
    from seamless_communication_torch.checkpoint.serialize import load_params
    from seamless_communication_torch.device import resolve_device
    from seamless_communication_torch.models.unit_extractor import (
        KmeansModel, UnitExtractor,
    )

    device = resolve_device(args.device)
    timings = {}
    t0 = time.perf_counter()
    wav, sr = read_wav(args.audio)
    wav = resample(wav, sr, 16000)
    t1 = time.perf_counter()
    if args.w2v2_checkpoint.endswith(".pt"):
        from seamless_communication_torch.checkpoint.convert_fairseq2 import (
            load_pt_state_dict, wav2vec2_raw_tree_from_pt,
        )
        params = wav2vec2_raw_tree_from_pt(load_pt_state_dict(args.w2v2_checkpoint))
    else:
        params = load_params(args.w2v2_checkpoint)
    kmeans = KmeansModel.from_npy(args.kmeans_path)
    t2 = time.perf_counter()
    extractor = UnitExtractor(params, kmeans, out_layer_idx=args.out_layer_number - 1,
                              device=device)
    t3 = time.perf_counter()
    units = extractor.predict(wav)
    timings.update(read_wav=t1 - t0, load=t2 - t1, build=t3 - t2,
                   **extractor.last_timings)
    logger.info("Units: %s", " ".join(map(str, units[0])))
    return AudioToUnitsResult(units[0], extractor, timings)


if __name__ == "__main__":
    main()
