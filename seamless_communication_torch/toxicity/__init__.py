"""Added-toxicity detection (ETOX) and mitigation (MinTox), host-side; the
MuToX classifier (``mutox``, ``mutox_speech``)."""

from seamless_communication_torch.toxicity.etox import ETOXBadWordChecker  # noqa: F401
from seamless_communication_torch.toxicity.mintox import mintox_pipeline  # noqa: F401
