"""repro_torch.serve — slot-batched serving of compiled graphs and of the
LM models."""
from .engine import CompiledGraphEngine, GraphRequest  # noqa: F401
from .generation import GenerationEngine, Request, greedy_generate  # noqa: F401
