"""repro_torch.dist — fault tolerance (counterpart of ``repro.dist``).

``fault``  watchdog and bounded restarts; the sharding rules, collectives
and ``elastic_mesh`` wait for ROADMAP.md A16 (multi-device).
"""
from . import fault  # noqa: F401
