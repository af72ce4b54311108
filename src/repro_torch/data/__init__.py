"""repro_torch.data — deterministic synthetic pipeline with resumable state."""
from .pipeline import StreamState, SyntheticLMStream, to_device  # noqa: F401
