"""repro_torch.ckpt — atomic checkpointing of a train state."""
from .manager import CheckpointManager  # noqa: F401
