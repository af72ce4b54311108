"""repro_torch.optim — AdamW, schedules and gradient compression, from
scratch (counterpart of ``repro.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
from .compress import CompressState, compress_init, compressed_grads  # noqa: F401
