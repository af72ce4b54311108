"""Cache-backed per-segment launch geometry (the ``tune=`` compile modes).

Counterpart of ``repro.tune.autotuner``.  ``Autotuner.blocks_for(sig)`` is
the one question the lowering rules ask: *which geometry should this
segment's kernel launch with?*  The answer, in the reference's order:

  1. the current graph's manifest (one file read per compile, loaded by
     ``begin_graph``),
  2. the shared per-kernel cache entry (another graph already searched
     this exact workload),
  3. mode == "search": measure and remember,
  4. otherwise the heuristic plan's own choices, counted as a miss.

The blocks are a launch plan's ``override`` (``kernels.*_launch_plan``),
and the default is not a constant: for each signature it is what the
plan's heuristic picks at that shape, read back from the plan
(``qmm_blocks``, ``gqmm_blocks``, ``dw_blocks``, ``qdq_blocks``).  A
cached entry the plan rejects is a miss and its file is unlinked.

The search is cheap by construction: the candidates are the plans'
choices limited to the template instances the built library has (B1 /
B2: tile x cluster split of K, with the fewest ring stages the split
allows; B2's int8 body: its one compile-time tile; B5: block columns x K
slice; B6: the plan's own candidates, cheapest first by its cost model;
B4: loads in flight x grid cap), each built through its plan (a
candidate the plan rejects is dropped, which is pruning), Pareto-pruned
on the roofline axes (``tune.roofline``) and truncated to
``max_candidates``.  The survivors and the heuristic are timed through the
real wrappers on seeded operands at the signature's shape.  On the card
each candidate's ``reps`` back-to-back calls are captured in one CUDA
graph and its replays timed with CUDA events, in interleaved rounds, best
of ``repeats`` (``obs.profile.time_fns_graphed``): a host clock around a
10 µs launch would time the launch, not the kernel.  A candidate that the
plan accepted and that then fails to launch is a fault and raises, naming
the signature and the blocks.  The heuristic wins ties (within
``TIE``); on the CPU the plain twins ignore geometry, so every candidate
ties and the heuristic is kept: there the search checks the plumbing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import roofline
from .cache import TuneCache
from .config import BlockConfig, KernelSig, bucket_rows

# a candidate must beat the heuristic by more than this share to replace it
TIE = 0.02
# CUDA-graphed calls per timed replay
GRAPH_REPS = 10
# the K slices B5's search weighs besides the whole of Kg
_GQ_SLICES = (16, 32, 64)


def _epi(sig: KernelSig) -> int:
    """B1 / B2's epilogue id for a matmul signature's body."""
    if sig.body == "f32":
        return 0
    return 2 if sig.requant == "int32" else 1


def _dw_shape(sig: KernelSig):
    """(N, C, H, W, OH, OW, kh, kw, strides, dilations, pads) of a
    depthwise signature, N from its bucketed rows; None without geometry."""
    if len(sig.geometry) != 14:
        return None
    H, W, OH, OW, kh, kw, sh, sw, dh, dw, *pads = sig.geometry
    N = max(1, sig.m // (OH * OW))
    return (N, sig.n, H, W, OH, OW, kh, kw, (sh, sw), (dh, dw), tuple(pads))


class Autotuner:
    """Per-compile geometry oracle over a shared ``TuneCache``.

    mode       — "cached" answers from cache or the heuristic (never
                 times); "search" also measures workloads the cache has
                 never seen (mode "off" never builds an Autotuner)
    repeats    — best-of-N timing rounds per candidate
    max_candidates — roofline survivors to time (plus the heuristic)
    device     — where the kernels are timed; ``backend`` and
                 ``interpret`` follow from it unless given (a CPU device
                 times the plain twins: ``interpret`` True, backend "cpu")
    """

    def __init__(self, cache: Optional[TuneCache] = None, *,
                 mode: str = "cached", repeats: int = 3,
                 max_candidates: int = 4, device=None,
                 interpret: Optional[bool] = None,
                 backend: Optional[str] = None):
        if mode not in ("cached", "search"):
            raise ValueError(f"tune mode must be 'cached' or 'search', "
                             f"got {mode!r}")
        if device is None and backend == "cpu":
            device = "cpu"
        from ..core.executor import resolve_device
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else TuneCache()
        self.mode = mode
        self.repeats = max(1, int(repeats))
        self.max_candidates = max(1, int(max_candidates))
        self.interpret = (self.device.type == "cpu") if interpret is None \
            else bool(interpret)
        if backend is None:
            backend = "cpu" if self.device.type == "cpu" else \
                f"cuda:{torch.cuda.get_device_name(self.device)}"
        self.backend = backend
        self.stats = {"graph_hit": 0, "graph_miss": 0,
                      "hits": 0, "misses": 0, "searched": 0}
        # one record per search: the sig, the candidates timed, the
        # heuristic's and the winner's blocks and milliseconds
        self.searches: list[dict] = []
        self._graph_key: Optional[str] = None
        self._manifest: dict = {}
        self._manifest_dirty = False

    # ---------------------------------------------------------- manifest
    def begin_graph(self, graph_key: str) -> None:
        """Load the per-graph manifest so warm compiles do one file read."""
        self._graph_key = graph_key
        self._manifest_dirty = False
        loaded = self.cache.load_manifest(graph_key)
        if loaded is not None:
            self._manifest = dict(loaded)
            self.stats["graph_hit"] += 1
        else:
            self._manifest = {}
            self.stats["graph_miss"] += 1

    def end_graph(self) -> None:
        """Persist the manifest if this compile added assignments."""
        if self._graph_key and self._manifest_dirty and self._manifest:
            self.cache.store_manifest(self._graph_key, self._manifest)
        self._graph_key = None
        self._manifest_dirty = False

    # ---------------------------------------------------------- identity
    def sig(self, family: str, *, rows: Optional[int], n: int, k: int,
            groups: int = 1, bits: int = 8, requant: str = "fp32",
            body: str = "", geometry: tuple = ()) -> KernelSig:
        """Build the content-addressed signature for one segment workload."""
        return KernelSig(family=family, m=bucket_rows(rows), n=int(n),
                         k=int(k), groups=int(groups), bits=int(bits),
                         requant=requant, backend=self.backend,
                         interpret=self.interpret, body=body,
                         geometry=tuple(int(v) for v in geometry))

    # ---------------------------------------------------------- the oracle
    def blocks_for(self, sig: KernelSig) -> BlockConfig:
        key = sig.canonical_json()
        cached = self._manifest.get(key)
        if cached is not None:
            if self.valid(sig, cached):
                self.stats["hits"] += 1
                return BlockConfig(blocks=tuple(cached), source="cached")
            del self._manifest[key]             # rejected: rewrite the manifest
            self._manifest_dirty = True
        entry = self.cache.lookup_kernel(sig, lambda b: self.valid(sig, b))
        if entry is not None:
            self.stats["hits"] += 1
            self._manifest[key] = entry.blocks
            self._manifest_dirty = True
            return entry
        default = self.heuristic(sig)
        if self.mode == "search" and default:
            cfg = self._search(sig, default)
            self._manifest[key] = cfg.blocks
            self._manifest_dirty = True
            return cfg
        self.stats["misses"] += 1
        return BlockConfig(blocks=default, source="default")

    # ---------------------------------------------------------- the plans
    def _plan(self, sig: KernelSig, blocks=None):
        """The launch plan of ``sig`` at its (bucketed) shape, with
        ``blocks`` as its override; raises ValueError where the plan
        rejects them."""
        from ..kernels import quant_dequant as qd
        from ..kernels import quant_grouped_conv as gc
        from ..kernels import quant_matmul as qm
        ov = None if blocks is None else tuple(blocks)
        if sig.family == "matmul":
            return qm.qmm_launch_plan(sig.m, sig.k, sig.n, sig.bits == 4,
                                      _epi(sig), override=ov)
        if sig.family == "grouped":
            return gc.gqmm_launch_plan(sig.groups, sig.m, sig.k, sig.n,
                                       override=ov)
        if sig.family == "depthwise":
            shape = _dw_shape(sig)
            if shape is None:
                raise ValueError(f"{sig}: no geometry")
            return gc.dw_launch_plan(*shape, override=ov)
        if sig.family == "qdq":
            return qd.qdq_launch_plan(sig.m * sig.n, max(1, sig.n), False,
                                      override=ov)
        raise ValueError(f"unknown kernel family {sig.family!r}")

    def heuristic(self, sig: KernelSig) -> tuple:
        """The heuristic plan's own blocks at ``sig``'s shape (() where the
        signature carries too little to build the plan)."""
        from ..kernels import quant_dequant as qd
        from ..kernels import quant_grouped_conv as gc
        from ..kernels import quant_matmul as qm
        if sig.family == "matmul" and sig.body == "int8_mma":
            return qm.qmm_i8_blocks(sig.k)
        try:
            plan = self._plan(sig)
        except ValueError:
            return ()
        return {"matmul": qm.qmm_blocks, "grouped": gc.gqmm_blocks,
                "depthwise": gc.dw_blocks, "qdq": qd.qdq_blocks}[sig.family](plan)

    def valid(self, sig: KernelSig, blocks) -> bool:
        """Whether ``sig``'s launch plan takes ``blocks`` as its override."""
        from ..kernels import quant_matmul as qm
        blocks = tuple(blocks)
        if sig.family == "matmul" and sig.body == "int8_mma":
            return blocks == qm.qmm_i8_blocks(sig.k)
        try:
            self._plan(sig, blocks)
        except (ValueError, TypeError):
            return False
        return True

    # ---------------------------------------------------------- search
    def _search(self, sig: KernelSig, default: tuple) -> BlockConfig:
        self.stats["searched"] += 1
        cands = [default] + [c for c in self.candidates(sig) if c != default]
        times = self._time_candidates(sig, cands)
        win = 0
        if not self.interpret:
            best = min(range(len(cands)), key=lambda i: times[i])
            if times[0] > times[best] * (1.0 + TIE):
                win = best
        self.cache.store_kernel(sig, cands[win], best_ms=times[win] * 1e3,
                                default_ms=times[0] * 1e3,
                                n_candidates=len(cands))
        self.searches.append({
            "sig": sig, "candidates": len(cands), "default": default,
            "default_ms": times[0] * 1e3, "blocks": cands[win],
            "ms": times[win] * 1e3})
        return BlockConfig(blocks=cands[win], source="search")

    def candidates(self, sig: KernelSig) -> list:
        """The blocks the search weighs besides the heuristic: each built
        through its plan (the plan's rejections dropped), dominated ones
        pruned on the roofline axes, at most ``max_candidates``."""
        from ..kernels import quant_matmul as qm
        if sig.family == "matmul":
            if sig.body == "int8_mma":
                return [qm.qmm_i8_blocks(sig.k)]
            packed, epi = sig.bits == 4, _epi(sig)
            raw = [(t, s, qm.qmm_min_stages(t, packed, epi, sig.k, s))
                   for t in qm.QMM_TILES for s in range(1, qm.QMM_CLUSTER_MAX + 1)]
            plans = self._built(sig, raw)

            def cost(b):
                p = plans[b]
                bm, bn = p.block
                return (roofline.matmul_plan_traffic(
                            sig.m, sig.n, sig.k, bm, bn,
                            w_bytes=0.5 if packed else 1),
                        p.smem,
                        roofline.wave_idle(p.grid[0] * p.grid[1],
                                           qm.QMM_THREADS, p.smem))
            return roofline.pareto_prune(list(plans), cost, self.max_candidates)
        if sig.family == "grouped":
            from ..kernels import quant_grouped_conv as gc
            most = min(max(4, -(-sig.k // 4) * 4), gc.GQ_KS_MAX)
            slices = sorted({most} | {v for v in _GQ_SLICES if v < most})
            plans = self._built(sig, [(bn, ks) for bn in gc.GQ_BNS
                                      for ks in slices])
            packed = sig.bits == 4

            def cost(b):
                p = plans[b]
                row_blocks = -(-p.M // gc.GQ_BM)
                traffic = p.G * (p.col_tiles * p.M * p.Kg * 4 +
                                 row_blocks * p.Kg * p.col_tiles * p.BN *
                                 (0.5 if packed else 1) + p.M * p.Ng * 4)
                blocks = row_blocks * p.col_tiles * p.G
                return (traffic, p.smem_bytes,
                        roofline.wave_idle(blocks, gc.GQ_BM, p.smem_bytes))
            return roofline.pareto_prune(list(plans), cost, self.max_candidates)
        if sig.family == "depthwise":
            from ..kernels import quant_grouped_conv as gc
            shape = _dw_shape(sig)
            ranked = [b for _, b in gc.dw_block_candidates(*shape)]
            return list(self._built(sig, ranked))[:self.max_candidates]
        if sig.family == "qdq":
            from ..kernels import quant_dequant as qd
            sms = roofline.SMS
            raw = [(u, cap) for u in (qd.QDQ_UMAX, 2, 1)
                   for cap in (sms * 2, sms * 4, sms * 8, qd.QDQ_MAX_BLOCKS)]
            plans = {}
            for b in raw:
                p = self._plan(sig, b)
                plans.setdefault(qd.qdq_blocks(p), p)

            def cost(b):
                p = plans[b]
                trips = -(-p.nvec // p.sweep) if p.nvec else 0
                return (roofline.wave_idle(p.blocks, qd.QDQ_THREADS, 1),
                        trips, 1.0 / p.unroll)
            return roofline.pareto_prune(list(plans), cost, self.max_candidates)
        raise ValueError(f"unknown kernel family {sig.family!r}")

    def _built(self, sig: KernelSig, raw) -> dict:
        """blocks -> plan for the candidates the plan accepts, in order and
        feasible on the card's shared memory; the rest is pruned."""
        out = {}
        for b in raw:
            try:
                p = self._plan(sig, b)
            except ValueError:
                continue
            smem = getattr(p, "smem", getattr(p, "smem_bytes", 0))
            if roofline.feasible(smem):
                out.setdefault(tuple(b), p)
        return out

    # ---------------------------------------------------------- timing
    def _time_candidates(self, sig: KernelSig, cands) -> list:
        """Best seconds per call of each candidate: graphed CUDA-event
        timing on the card, the host clock around the twins on the CPU.
        A candidate that fails to run raises, naming the sig and blocks."""
        from ..obs.profile import time_fns, time_fns_graphed
        fns = [self._make_fn(sig, b) for b in cands]
        for fn, b in zip(fns, cands):
            try:
                fn()                     # first call: the launch itself
            except Exception as e:
                raise RuntimeError(f"autotuner: {sig} with blocks {b} passed "
                                   f"its plan's check but failed to run: {e}") from e
        try:
            if self.device.type == "cuda":
                return time_fns_graphed(fns, self.repeats, reps=GRAPH_REPS,
                                        device=self.device)
            return time_fns(fns, self.repeats, warmup=0)
        except Exception as e:
            raise RuntimeError(f"autotuner: timing {sig} over {cands} "
                               f"failed: {e}") from e

    def _make_fn(self, sig: KernelSig, blocks):
        """A call of the real wrapper at ``sig``'s shape with ``blocks``,
        on seeded operands on the tuner's device (integer-valued x on the
        integer bodies, staged by a power-of-two scale, as the main path's
        are)."""
        from ..kernels import ops
        from ..kernels.requant import IntRequant
        dev = self.device
        rng = np.random.RandomState(0)
        int_path = sig.requant == "int32"
        int_acc = int_path or sig.body in ("imad", "int8_mma")
        in_scale = 0.125 if int_acc else None
        requant = IntRequant(shift=8, relu=True, has_act=True, act_shift=4,
                             act_lo=0, act_hi=15, act_out_shift=2) \
            if int_path else None
        acc = torch.int32 if int_acc else torch.float32
        blocks = tuple(blocks)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def acts(*shape):
            if int_acc:
                return t(rng.randint(-8, 8, shape).astype(np.float32) * in_scale)
            return t(rng.randn(*shape).astype(np.float32))

        def scale(n):
            return t(np.ones(n, np.int32 if int_path else np.float32))
        body = dict(acc_dtype=acc, requant=requant, in_scale=in_scale)
        m, n, k = sig.m, sig.n, sig.k
        if sig.family == "matmul":
            x, s = acts(m, k), scale(n)
            w = rng.randint(-7, 8, (k, n)).astype(np.int8)
            if sig.bits == 4:
                wp = ops.pack_int4(torch.from_numpy(w)).to(dev)
                return lambda: ops.quant_matmul_int4(
                    x, wp, s, blocks=blocks,
                    int8_codes=sig.body == "int8_mma", **body)
            wd = t(w)
            return lambda: ops.quant_matmul(x, wd, s, blocks=blocks, **body)
        if sig.family == "grouped":
            g = max(1, sig.groups)
            patches = acts(m, g * k)
            xg = patches.view(m, g, k).permute(1, 0, 2)
            w = torch.from_numpy(rng.randint(-7, 8, (g, k, n)).astype(np.int8))
            wg = (ops.pack_int4_grouped(w) if sig.bits == 4 else w).to(dev)
            sg = scale(g * n)
            return lambda: ops.quant_grouped_matmul(
                xg, wg, sg, packed=sig.bits == 4, blocks=blocks, **body)
        if sig.family == "depthwise":
            N, C, H, W, OH, OW, kh, kw, st, dl, pads = _dw_shape(sig)
            x = acts(N, C, H, W)
            taps = t(rng.randint(-7, 8, (kh * kw, C)).astype(np.int8))
            sd = scale(C)
            return lambda: ops.quant_depthwise_conv2d(
                x, taps, sd, kernel_shape=(kh, kw), strides=st, pads=pads,
                dilations=dl, blocks=blocks, **body)
        if sig.family == "qdq":
            x = t(rng.randn(m, max(1, n)).astype(np.float32))
            qs, qz = t(np.float32([0.05])), t(np.float32([0.0]))
            return lambda: ops.quant_dequant(
                x, qs, qz, bit_width=sig.bits or 8, blocks=blocks)
        raise ValueError(f"unknown kernel family {sig.family!r}")
