"""Unit extraction: the XLSR2-1B raw-waveform encoder and the k-means
quantizer."""

from seamless_communication_torch.models.unit_extractor.unit_extractor import (  # noqa: F401
    KmeansModel, UnitExtractor,
)
from seamless_communication_torch.models.unit_extractor.wav2vec2_raw import (  # noqa: F401
    Wav2Vec2RawConfig, wav2vec2_layer_output, wav2vec2_raw_init,
)
