"""repro_torch.dist — sharding rules, meshes, collectives and fault
tolerance (counterpart of ``repro.dist``).

``sharding``     the ``Mesh`` type and the name-based partition-spec rules
                 for params / batches / caches
``collectives``  quantized all-reduce + error-feedback compression
``fault``        watchdog, bounded restarts, elastic mesh derivation
"""
from . import collectives, fault, sharding  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh,
    P,
    batch_pspecs,
    cache_pspecs,
    data_axis_size,
    distribute,
    param_pspecs,
    to_shardings,
)
