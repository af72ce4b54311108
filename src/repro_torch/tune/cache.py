"""Content-addressed on-disk tune cache.

Counterpart of ``repro.tune.cache``, in the reference's layout (default
root ``~/.cache/repro-tune``, overridable with the ``REPRO_TUNE_CACHE_DIR``
env var or the ``tune_cache_dir=`` argument):

    <root>/kernels/<sha>.json    one entry per KernelSig x kernel version:
                                 the winning blocks + search telemetry,
                                 shared across graphs
    <root>/graphs/<sha>.json     per-graph manifest: sig-key -> blocks, so
                                 a warm reload answers every segment from
                                 one file read

Keys are content hashes:

  * kernel entry — sha256(KernelSig canonical JSON + ``kernel_version()``),
    where ``kernel_version`` digests every ``repro_torch/kernels/*.py`` and
    the CUDA build's own digest (``kernels._build._digest``: the nvcc flags
    and every ``csrc/*.cu`` / ``*.cuh``), so editing a kernel or a plan
    invalidates every entry.  The reference's entries fold in its own
    kernel digest, so the two packages never read each other's entries
    from one root.
  * graph manifest — sha256(graph_hash + backend + kernel_version), where
    ``graph_hash`` digests the port's deterministic
    ``serialize.graph_to_json``: weights, shapes, bit widths, topology.

Robustness contract: the cache can be deleted, truncated, corrupted or
raced at any time and the worst case is a re-search.  ``lookup_*`` returns
None on any decode error and unlinks the bad file; an entry that decodes
but whose blocks the launch plan rejects is treated the same way (the
caller passes the plan's check as ``valid``); writes are atomic (a tmp
file in the same dir, then ``os.replace``), so a concurrent reader never
sees half an entry and the last concurrent writer wins whole-file.

The reference's second store, JAX's persistent compilation cache, has no
counterpart to configure: the port's kernels are one library built once
per source digest into ``kernels._build.build_dir()``, which persists by
itself.  ``configure_persistent_cache`` returns that directory.
"""
from __future__ import annotations

import functools
import glob
import hashlib
import json
import os
import tempfile
from typing import Callable, Optional

from .config import BlockConfig, KernelSig

_ENV_VAR = "REPRO_TUNE_CACHE_DIR"
_DEFAULT_ROOT = os.path.join("~", ".cache", "repro-tune")


@functools.lru_cache(maxsize=1)
def kernel_version() -> str:
    """sha256 over the kernel package's Python sources and the CUDA
    build's digest: the tune-entry version stamp."""
    from ..kernels import _build
    kern_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "kernels")
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(kern_dir, "*.py"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(_build._digest().encode())
    return h.hexdigest()


def graph_hash(graph) -> str:
    """sha256 of the graph's deterministic serialized form (weights,
    shapes, quantizer bit widths, topology): any change is a new hash."""
    from ..core.serialize import graph_to_json
    doc = json.dumps(graph_to_json(graph), sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()


def graph_cache_key(graph, backend: str = "cpu") -> str:
    """Manifest key: graph content x timing backend x kernel sources."""
    h = hashlib.sha256()
    h.update(graph_hash(graph).encode())
    h.update(backend.encode())
    h.update(kernel_version().encode())
    return h.hexdigest()


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _read_json(path: str) -> Optional[dict]:
    """Load a cache file; any failure (missing, truncated, corrupt, not a
    dict) is a miss.  Corrupt files are unlinked so they don't mask future
    stores."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("cache entry is not an object")
        return doc
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        _unlink(path)
        return None


class TuneCache:
    """The on-disk launch-geometry store (see the module docstring).

    ``persist_executables`` keeps the reference's keyword: True points the
    process at the kernels' build directory (``configure_persistent_cache``),
    which moves nothing."""

    def __init__(self, root: Optional[str] = None, *,
                 persist_executables: bool = True):
        root = root or os.environ.get(_ENV_VAR) or _DEFAULT_ROOT
        self.root = os.path.abspath(os.path.expanduser(root))
        self.kernels_dir = os.path.join(self.root, "kernels")
        self.graphs_dir = os.path.join(self.root, "graphs")
        if persist_executables:
            configure_persistent_cache()

    # -- kernel entries (shared across graphs) -------------------------
    def _kernel_path(self, sig: KernelSig) -> str:
        h = hashlib.sha256()
        h.update(sig.canonical_json().encode())
        h.update(kernel_version().encode())
        return os.path.join(self.kernels_dir, h.hexdigest() + ".json")

    def lookup_kernel(self, sig: KernelSig,
                      valid: Optional[Callable[[tuple], bool]] = None
                      ) -> Optional[BlockConfig]:
        """The stored blocks of ``sig``, or None.  ``valid(blocks)`` False
        (the launch plan rejects them) makes the entry a miss, and its
        file is unlinked like a corrupt one's."""
        path = self._kernel_path(sig)
        doc = _read_json(path)
        if doc is None:
            return None
        try:
            blocks = tuple(int(b) for b in doc["blocks"])
        except (KeyError, TypeError, ValueError):
            _unlink(path)
            return None
        if valid is not None and not valid(blocks):
            _unlink(path)
            return None
        return BlockConfig(blocks=blocks, source="cached")

    def store_kernel(self, sig: KernelSig, blocks, *,
                     best_ms: Optional[float] = None,
                     n_candidates: Optional[int] = None,
                     default_ms: Optional[float] = None) -> None:
        doc = {"sig": json.loads(sig.canonical_json()),
               "blocks": [int(b) for b in blocks],
               "kernel_version": kernel_version()}
        if best_ms is not None:
            doc["best_ms"] = float(best_ms)
        if default_ms is not None:
            doc["default_ms"] = float(default_ms)
        if n_candidates is not None:
            doc["n_candidates"] = int(n_candidates)
        _atomic_write_json(self._kernel_path(sig), doc)

    # -- per-graph manifests -------------------------------------------
    def _graph_path(self, graph_key: str) -> str:
        return os.path.join(self.graphs_dir, graph_key + ".json")

    def load_manifest(self, graph_key: str) -> Optional[dict]:
        """sig-key -> blocks mapping for a previously tuned graph."""
        path = self._graph_path(graph_key)
        doc = _read_json(path)
        if doc is None:
            return None
        mapping = doc.get("segments")
        if not isinstance(mapping, dict):
            _unlink(path)
            return None
        out = {}
        try:
            for key, blocks in mapping.items():
                out[key] = tuple(int(b) for b in blocks)
        except (TypeError, ValueError):
            _unlink(path)
            return None
        return out

    def store_manifest(self, graph_key: str, mapping: dict) -> None:
        doc = {"kernel_version": kernel_version(),
               "segments": {k: [int(b) for b in v]
                            for k, v in mapping.items()}}
        _atomic_write_json(self._graph_path(graph_key), doc)


_persistent_cache_dir: list = []            # once-per-process latch


def configure_persistent_cache() -> str:
    """The directory the compiled kernels persist in across processes
    (``kernels._build.build_dir()``), latched once per process.  The
    library is built there once per digest of its sources and flags and
    loaded as built afterwards, so there is nothing to configure: this is
    the counterpart of the reference's ``configure_jax_persistent_cache``
    and moves nothing."""
    if not _persistent_cache_dir:
        from ..kernels import _build
        _persistent_cache_dir.append(str(_build.build_dir()))
    return _persistent_cache_dir[0]
