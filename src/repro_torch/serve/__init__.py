"""repro_torch.serve — the pipelined serving tier (counterpart of
``repro.serve``).

* ``generation``  — batched LM generation (``GenerationEngine``)
* ``engine``      — compiled-QONNX-graph serving (``CompiledGraphEngine``:
                    slot batching over the plan's captured CUDA graph,
                    pipelined multi-chunk dispatch, request futures with
                    latency telemetry)
* ``scheduler``   — ``ServeScheduler``: background flush loop with bounded
                    queue backpressure and deadline-aware flush windows
* ``registry``    — ``EngineRegistry``: multi-model routing + atomic
                    hot-swap reloads
* ``splitmerge``  — ``SplitMergeFront``: shard request waves across
                    per-device workers, deterministic submission-order
                    merge, failed shards re-dispatched (zero lost requests)
"""
from .engine import CompiledGraphEngine, GraphRequest  # noqa: F401
from .generation import (  # noqa: F401
    GenerationEngine,
    Request,
    greedy_generate,
)
from .registry import EngineRegistry  # noqa: F401
from .scheduler import QueueFull, ServeScheduler  # noqa: F401
from .splitmerge import (  # noqa: F401
    SplitMergeFront,
    Wave,
    Worker,
    WorkerFailed,
    device_workers,
)

__all__ = [
    "CompiledGraphEngine",
    "EngineRegistry",
    "GenerationEngine",
    "GraphRequest",
    "QueueFull",
    "Request",
    "ServeScheduler",
    "SplitMergeFront",
    "Wave",
    "Worker",
    "WorkerFailed",
    "device_workers",
    "greedy_generate",
]
