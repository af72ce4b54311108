"""repro_torch.serve — slot-batched serving of compiled graphs."""
from .engine import CompiledGraphEngine, GraphRequest  # noqa: F401
