"""repro_torch.dist — fault tolerance and gradient compression
(counterpart of ``repro.dist``).

``fault``        watchdog and bounded restarts;
``collectives``  error-feedback int8 compression (``ef_compress``).
The sharding rules, ``quantized_psum`` and ``elastic_mesh`` wait for
ROADMAP.md A16 (multi-device).
"""
from . import collectives, fault  # noqa: F401
