"""The UnitY2 forced aligner."""

from seamless_communication_torch.models.aligner.model import (  # noqa: F401
    AlignerConfig, aligner_forward, aligner_init, viterbi_durations,
)
