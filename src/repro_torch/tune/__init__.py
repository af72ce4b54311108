"""repro_torch.tune — launch-geometry autotuner and its persistent cache.

Counterpart of ``repro.tune``.  The port's kernels take their geometry
from host launch plans (``kernels.*_launch_plan``) whose heuristics were
never searched; this package makes the geometry a per-workload decision
with memory:

  * ``roofline``  — the H100's machine constants, plan traffic and
                    last-wave idle share, and Pareto pruning;
  * ``config``    — ``KernelSig`` (content-addressed workload identity:
                    family x shape bucket x carrier bits x requant path x
                    body x geometry x backend) and ``BlockConfig`` (the
                    chosen plan override + provenance);
  * ``cache``     — ``TuneCache``: atomic, corrupt-tolerant on-disk store
                    (``~/.cache/repro-tune`` / ``$REPRO_TUNE_CACHE_DIR``)
                    of per-kernel entries and per-graph manifests, keyed
                    by content hashes that fold in ``kernel_version()``;
                    ``configure_persistent_cache`` names where the built
                    kernels persist;
  * ``autotuner`` — ``Autotuner``: the oracle ``compile_graph(tune=...)``
                    threads through the lowering rules; answers from the
                    manifest, the shared cache, or (mode "search") a
                    roofline-pruned, CUDA-graph-timed best-of-N of the
                    real kernels with each candidate geometry.

Entry points: ``compile_graph(graph, tune="cached"|"search")``,
``CompiledGraphEngine(..., tune=...)`` and
``python -m repro_torch.launch.serve --tune ...``.
"""
from .autotuner import Autotuner  # noqa: F401
from .cache import (  # noqa: F401
    TuneCache, configure_persistent_cache, graph_cache_key, graph_hash,
    kernel_version)
from .config import BlockConfig, KernelSig, bucket_rows  # noqa: F401
from . import roofline  # noqa: F401

__all__ = [
    "Autotuner",
    "BlockConfig",
    "KernelSig",
    "TuneCache",
    "bucket_rows",
    "configure_persistent_cache",
    "graph_cache_key",
    "graph_hash",
    "kernel_version",
    "roofline",
]
