"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on meta
tensors over a fake process group (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step for its
production meshes (16x16 = 256 devices, and 2x16x16 = 512) and reads the
collectives out of the partitioned HLO.  The port runs the same step on
DTensors instead: the parameters, the train state, the batch and the
cache are meta-device shards placed by ``param_pspecs`` / ``batch_pspecs``
/ ``cache_pspecs`` over a DeviceMesh of a fake process group (backend
``"fake"``, ``FakeStore`` from ``torch.testing._internal``) of 256 or 512
ranks, seen from rank 0.  Nothing is computed and nothing is allocated:
the step runs once, under a dispatch mode (``CellTrace``) that sees the
ops DTensor issues on rank 0's shards and records

  * ``collectives``: every functional collective DTensor issues
    (``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
    ``all_to_all_single`` and their coalesced forms), under the
    reference's five names, each counting the bytes of its local result
    (the reference's per-device convention): ``{bytes, counts,
    total_bytes}``;
  * ``cost_analysis.flops``: per chip, the FLOPs of the ops on rank 0's
    shards, by torch's FLOP formulas (``torch.utils.flop_counter``:
    matmuls, convolutions and attention; elementwise ops count none);
  * ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes``, the bytes of rank 0's shards of the step's
    inputs and outputs.

No other field is recorded: a trace measures no ``bytes accessed``, no
``temp_size_in_bytes`` and no HLO size.

The DeviceMesh is of type ``cuda`` unless ``--device-type cpu`` is given
(the CPU tests pass it); a ``cuda`` mesh without CUDA raises.  The decode
cells write their token at ``cache_index = S - 1``, so every chunk of the
cache is attended, as the reference's traced index leaves every chunk in
its program.

Each cell is traced at one and two layer units (pattern groups for the
hybrid, from zero: its tail layers stay; encoder + decoder layers for
audio) and its figures extrapolated linearly to the full depth, which is
exact: every unit issues the same
ops on the same shards (``trace_cell``; the tests hold it to a direct
trace).  rwkv6's time loop (``models/rwkv6.py``) runs on meta shards as
one step over all S positions: the same per-step ops, each counted S
times, and no collective inside the loop.  The reference counts that
loop's body once (its XLA while loop): ROADMAP C23.

Records go to ``experiments/dryrun_torch/``.  ``run_cell`` makes its own
group and destroys it, so no group outlives a cell.

    python -m repro_torch.launch.dryrun --mesh both --device-type cpu
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import all_archs, get_config, get_smoke_config
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.train.loop import TrainHyper, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the functional collectives DTensor issues, by the reference's names
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# (B, S) of the SMOKE cells the tests trace
SMOKE_DIMS = {"train_4k": (16, 32), "prefill_32k": (4, 32), "decode_32k": (8, 32),
              "long_500k": (4, 64)}


def collective_bytes(events) -> dict:
    """Per-collective-type result bytes and counts of ``events``, an
    iterable of (reference op name, local result bytes), one per
    collective a trace recorded."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    counts = {op: 0 for op in COLLECTIVE_OPS}
    for op, nbytes in events:
        out[op] += int(nbytes)
        counts[op] += 1
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


def _nbytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from repro_torch.models.common import is_dtensor
    if isinstance(tree, torch.nn.Module):
        return sum(_nbytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        return t.numel() * t.element_size()
    return 0


class CellTrace:
    """A dispatch mode that records the collectives and FLOPs of the ops
    run on this rank's shards.  A DTensor op is handed back to DTensor
    (``NotImplemented``), which issues its collectives and its local ops
    on plain tensors; those come back through the mode and are recorded.
    The fake-tensor runs of DTensor's shape inference are not."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        trace = self
        self.events = []
        self.flops = 0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                packet = getattr(func, "_overloadpacket", None)
                # DTensor infers a result's global shape by running the op
                # on fake tensors of the global shapes: no rank runs that
                if packet is None or any(issubclass(t, FakeTensor) for t in types):
                    return out
                name = _FUNCOL.get(packet.__name__)
                if name is not None and "c10d" in str(packet):
                    trace.events.append((name, _nbytes(out)))
                elif packet in flop_registry:
                    trace.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
                return out

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def collectives(self) -> dict:
        return collective_bytes(self.events)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0),
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def meta_mesh(multi_pod: bool, mesh_shape: tuple = None):
    """The production mesh (``make_production_mesh``) of meta entries, or
    one of ``mesh_shape``: (data, model) or (pod, data, model)."""
    if mesh_shape is None:
        return make_production_mesh(
            multi_pod=multi_pod, devices=[torch.device("meta")] * (512 if multi_pod else 256))
    axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    n = math.prod(mesh_shape)
    return tsh.Mesh(np.array([torch.device("meta")] * n, dtype=object).reshape(mesh_shape),
                    axes)


def traced_mesh(mesh):
    """The mesh a cell is traced over: the production mesh, its data axes
    joined into one ("pod", "data" -> "data" of 32 on the multi-pod mesh,
    pod-major, the same ranks).  Every rule shards over the data axes
    jointly (``dist.sharding``: batches, FSDP, the hooks), so the specs
    are the same; DTensor then issues one collective over them, as GSPMD
    does, where a 3-d DeviceMesh would issue one per axis (and its
    redistribution planner searches minutes per cell)."""
    data = [a for a in mesh.axis_names if a != "model"]
    if len(data) <= 1:
        return mesh
    model = mesh.shape.get("model", 1)
    return tsh.Mesh(mesh.devices.reshape(-1, model), ("data", "model"))


def check_device_type(device_type: str) -> str:
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', not {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda DeviceMesh needs CUDA; pass --device-type cpu "
                           "(device_type='cpu') to trace on the CPU")
    return device_type


# ----------------------------------------------------------- cell builders

def arch_config(arch: str, shape: str, quant: str,
                roofline: bool = False, shard_acts: bool = False,
                smoke: bool = False) -> ModelConfig:
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    recipe = FP32 if quant == "fp" else QuantRecipe.w_a(8, 8, kv_cache_bits=(
        8 if "decode" in shape or "long" in shape else None))
    kw = dict(quant=recipe)
    if api.SHAPES[shape]["kind"] == "train":
        kw["remat"] = True
    if roofline:
        # the reference unrolls its layer / chunk scans here; the port's
        # loops are Python loops, counted whole either way
        kw["scan_unroll"] = True
    if shard_acts:
        kw["shard_activations"] = True
    return cfg.replace(**kw)


def cell_dims(shape: str, dims=None) -> tuple:
    """(B, S) of a cell: ``dims`` where given, else the shape's."""
    if dims is not None:
        return tuple(dims)
    return api.SHAPES[shape]["global_batch"], api.SHAPES[shape]["seq_len"]


def _placed(tree, pspecs, mesh):
    return tsh.distribute(tree, tsh.to_shardings(pspecs, mesh))


def lower_cell(cfg: ModelConfig, shape: str, mesh, *, microbatches: int = 4,
               shard_overrides: dict | None = None, fsdp_exclude: tuple = (),
               dims=None):
    """Place one cell's step and its inputs on ``mesh`` (whose DeviceMesh
    is built), B rows of S tokens (``dims``, default the shape's).
    Returns (run, meta): ``run()`` takes the step once and gives
    (inputs, outputs)."""
    kind = api.SHAPES[shape]["kind"]
    B, S = cell_dims(shape, dims)
    specs = api.specs_for(cfg, kind, B, S)
    model = api.empty_params(cfg, "meta")

    if kind == "train":
        hyper = TrainHyper(microbatches=microbatches,
                           moe_aux_weight=0.01 if cfg.family == "moe" else 0.0)
        step = make_train_step(cfg, hyper)
        model.requires_grad_(True)
        named = dict(model.named_parameters())
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
        scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
        opt = AdamWState(step=scalar(), mu={k: f32(p) for k, p in named.items()},
                         nu={k: f32(p) for k, p in named.items()})
        state = {"params": model, "opt": opt, "step": scalar()}
        pspecs = tsh.param_pspecs(state, mesh, overrides=shard_overrides,
                                  fsdp_exclude=fsdp_exclude)
        tsh.distribute_model(model, tsh.to_shardings(pspecs["params"], mesh))
        state = {"params": model, "opt": _placed(opt, pspecs["opt"], mesh),
                 "step": _placed(state["step"], pspecs["step"], mesh)}
        batch = _placed(specs["batch"], tsh.batch_pspecs(specs["batch"], mesh), mesh)

        def run():
            inputs = (state, batch)
            return inputs, step(state, batch)
        return run, {"kind": kind, "microbatches": microbatches}

    pspecs = tsh.param_pspecs(model, mesh, fsdp=False, overrides=shard_overrides,
                              fsdp_exclude=fsdp_exclude)
    tsh.distribute_model(model, tsh.to_shardings(pspecs, mesh))
    if kind == "prefill":
        batch = _placed(specs["batch"], tsh.batch_pspecs(specs["batch"], mesh), mesh)

        def run():
            return (model, batch), api.prefill(model, batch, cfg, specs["cache_len"])
        return run, {"kind": kind}

    # decode: one token at the cache's last position
    cache = _placed(specs["cache"], tsh.cache_pspecs(
        specs["cache"], mesh, tp_last_dim=cfg.shard_activations), mesh)
    tokens = _placed(specs["tokens"], tsh.batch_pspecs(specs["tokens"], mesh), mesh)
    cache_index = S - 1

    def run():
        return ((model, cache, tokens),
                api.decode_step(model, cache, tokens, cache_index, cfg))
    return run, {"kind": kind, "cache_index": cache_index}


def _trace(cfg, shape, mesh, compile_: bool = True, **lower_kw) -> dict:
    """Place and run one cell's step under ``CellTrace``: its collectives,
    and (``compile_``) its per-chip FLOPs and argument / output bytes."""
    run, meta = lower_cell(cfg, shape, mesh, **lower_kw)
    trace = CellTrace()
    with mesh, trace:
        inputs, outputs = run()
    out = dict(meta, collectives=trace.collectives())
    if compile_:
        out["cost_analysis"] = {"flops": float(trace.flops)}
        out["memory_analysis"] = {"argument_size_in_bytes": _nbytes(inputs),
                                  "output_size_in_bytes": _nbytes(outputs)}
    return out


def _extrapolate(r1: dict, r2: dict, u: int, n: int) -> dict:
    """r1 + (n - u) * (r2 - r1) over every number of two trace records,
    those of u and u + 1 layer units: the record of n units."""
    def lin(a, b):
        if isinstance(a, dict):
            return {k: lin(a[k], b[k]) for k in a}
        return a + (b - a) * (n - u)
    return lin(r1, r2)


def _measures(rec: dict) -> dict:
    return {k: rec[k] for k in ("collectives", "cost_analysis", "memory_analysis")
            if k in rec}


def depth_units(cfg: ModelConfig):
    """(n_units, at): the cell's depth in identical layer units and
    ``at(n)``, its config cut to n units, every layer beyond the units
    kept (the hybrid's tail).  A unit is a layer, an encoder plus a
    decoder layer (audio) or one block pattern (hybrid)."""
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        n_units, tail = divmod(cfg.n_layers, plen)
        return n_units, lambda n: cfg.replace(n_layers=n * plen + tail)
    if cfg.family == "audio":
        if cfg.n_enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.n_enc_layers} encoder and {cfg.n_layers} "
                             "decoder layers make no identical units")
        return cfg.n_layers, lambda n: cfg.replace(n_layers=n, n_enc_layers=n)
    return cfg.n_layers, lambda n: cfg.replace(n_layers=n)


def trace_cell(cfg: ModelConfig, shape: str, mesh, *, compile_: bool = True,
               dims=None, **lower_kw) -> dict:
    """The cell's records, traced at 1 and 2 layer units (the hybrid: 0
    and 1, its tail kept) and extrapolated linearly to the cell's depth
    (every unit issues the same ops on the same shards, so each figure is
    affine in the depth; the tests hold the extrapolation to a direct
    trace), as ``extrapolation["depth"]`` records; a cell no deeper than
    the second is traced whole.  rwkv6's time loop
    runs on the meta shards as one step over all positions
    (``models.rwkv6._wkv_meta``: S times one step's FLOPs, no collective
    inside), recorded as ``extrapolation["time_loop"]``."""
    n_units, at = depth_units(cfg)
    kw = dict(lower_kw, dims=cell_dims(shape, dims))
    # the first two depths with layers: a step's boundaries (embedding,
    # head, loss) then meet a layer as at every depth; the hybrid's tail
    # gives its zero-unit config layers
    u = 0 if at(0).n_layers else 1
    if n_units <= u + 1:
        out, depth = _trace(at(n_units), shape, mesh, compile_, **kw), None
    else:
        r1 = _trace(at(u), shape, mesh, compile_, **kw)
        r2 = _trace(at(u + 1), shape, mesh, compile_, **kw)
        out = {k: v for k, v in r1.items() if k not in _measures(r1)}
        out.update(_extrapolate(_measures(r1), _measures(r2), u, n_units))
        depth = {"units": [u, u + 1], "n_units": n_units,
                 "c1": _measures(r1), "c2": _measures(r2)}
    out["extrapolation"] = {"depth": depth}
    if cfg.family == "ssm":
        out["extrapolation"]["time_loop"] = (
            "the wkv recurrence's S steps traced as one step over S positions: "
            "each per-step op counted S times")
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool, quant: str = "w8a8",
             compile_: bool = True, tag: str = "", roofline: bool = False,
             device_type: str = "cuda", smoke: bool = False,
             mesh_shape: tuple = None) -> dict:
    """One cell's record.  ``smoke`` takes the arch's SMOKE config at
    ``SMOKE_DIMS`` and ``mesh_shape`` another mesh ((data, model) or
    (pod, data, model)) than the production one: the tests' small cells."""
    mesh_name = "multi" if multi_pod else "single"
    cfg = arch_config(arch, shape, quant, roofline=roofline, smoke=smoke)
    skip = api.shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "quant": quant,
           "family": cfg.family, "tag": tag, "device_type": device_type}
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    t0 = time.time()
    try:
        check_device_type(device_type)
        mesh = traced_mesh(meta_mesh(multi_pod, mesh_shape))
        rec["device_mesh"] = dict(mesh.shape)
        with fake_group(mesh.size):
            mesh.device_mesh(device_type)
            rec.update(trace_cell(cfg, shape, mesh, compile_=compile_,
                                  dims=SMOKE_DIMS[shape] if smoke else None,
                                  microbatches=1 if roofline else 4))
        rec["lower_s"] = round(time.time() - t0, 1)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a result
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["total_s"] = round(time.time() - t0, 1)
    gc.collect()
    return rec


def _layers_reduced(cfg: ModelConfig, n: int):
    """Config with n layer-units (hybrid: n pattern groups; audio: n enc +
    n dec layers).  Returns (reduced_cfg, n_units, tail_fraction)."""
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        n_units = cfg.n_layers // plen
        tail = (cfg.n_layers - n_units * plen) / plen
        return cfg.replace(n_layers=n * plen), n_units, tail
    if cfg.family == "audio":
        return cfg.replace(n_layers=n, n_enc_layers=n), cfg.n_layers, 0.0
    return cfg.replace(n_layers=n), cfg.n_layers, 0.0


def _cell_costs(cfg, shape, mesh, **lower_kw) -> dict:
    """One trace of ``cfg`` at its own depth (no extrapolation: the
    roofline mode extrapolates from these)."""
    rec = _trace(cfg, shape, mesh, microbatches=1, dims=cell_dims(shape), **lower_kw)
    return {"flops": float(rec["cost_analysis"]["flops"]),
            "collective_bytes": float(rec["collectives"]["total_bytes"])}


def run_roofline_cell(arch: str, shape: str, *, quant: str = "w8a8",
                      shard_acts: bool = False, embed_dshard: bool = False,
                      tag: str = "roofline", device_type: str = "cuda") -> dict:
    """Per-chip FLOPs and collective bytes from 1- and 2-unit traces,
    extrapolated as the reference does: total = c1 + (units - 1 + tail)
    * (c2 - c1), re-anchored on (2, 3) units where a figure of the 2-unit
    trace falls below the 1-unit one.  Each of the three configs is
    traced whole (``_cell_costs``)."""
    rec = {"arch": arch, "shape": shape, "mesh": "single", "quant": quant,
           "tag": tag, "device_type": device_type,
           "opts": {"shard_acts": shard_acts, "embed_dshard": embed_dshard}}
    cfg = arch_config(arch, shape, quant, roofline=True, shard_acts=shard_acts)
    rec["family"] = cfg.family
    skip = api.shape_applicable(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    t0 = time.time()
    try:
        check_device_type(device_type)
        lower_kw = {"fsdp_exclude": ("embed", "lm_head")} if embed_dshard else {}
        mesh = make_production_mesh(devices=[torch.device("meta")] * 256)
        with fake_group(mesh.size):
            mesh.device_mesh(device_type)
            cfg1, n_units, tail = _layers_reduced(cfg, 1)
            cfg2, _, _ = _layers_reduced(cfg, 2)
            c1 = _cell_costs(cfg1, shape, mesh, **lower_kw)
            c2 = _cell_costs(cfg2, shape, mesh, **lower_kw)
            base, base_n = c1, 1
            if any(c2[k] < c1[k] for k in c1):
                cfg3, _, _ = _layers_reduced(cfg, 3)
                c3 = _cell_costs(cfg3, shape, mesh, **lower_kw)
                base, base_n, c1, c2 = c2, 2, c2, c3
        delta = {k: c2[k] - c1[k] for k in c1}
        mult = (n_units - base_n) + tail
        total = {k: base[k] + mult * delta[k] for k in base}
        rec["cost_analysis"] = {"flops": total["flops"]}
        rec["collectives"] = {"total_bytes": total["collective_bytes"]}
        rec["extrapolation"] = {"c1": c1, "c2": c2, "n_units": n_units,
                                "tail": tail, "base_n": base_n}
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["total_s"] = round(time.time() - t0, 1)
    gc.collect()
    return rec


def save_record(rec: dict, tag: str = "", results_dir=None):
    out = Path(results_dir) if results_dir is not None else RESULTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{rec['quant']}{suffix}.json"
    (out / name).write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(api.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="w8a8", choices=["fp", "w8a8"])
    ap.add_argument("--no-compile", action="store_true",
                    help="record the collectives only (no FLOPs, no memory)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--roofline", action="store_true",
                    help="1- / 2-unit extrapolated cost mode (tag=roofline)")
    ap.add_argument("--shard-acts", action="store_true",
                    help="perf: constrain attention intermediates (opt1)")
    ap.add_argument("--embed-dshard", action="store_true",
                    help="perf: embedding and head out of FSDP (opt2)")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"],
                    help="the DeviceMesh's device type (the shards are meta)")
    ap.add_argument("--results-dir", default=None,
                    help=f"where records go (default {RESULTS_DIR})")
    args = ap.parse_args(argv)
    if args.roofline and not args.tag:
        args.tag = "roofline"

    archs = [args.arch] if args.arch else all_archs()
    shapes = [args.shape] if args.shape else list(api.SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            if args.roofline:
                rec = run_roofline_cell(arch, shape, quant=args.quant,
                                        shard_acts=args.shard_acts,
                                        embed_dshard=args.embed_dshard, tag=args.tag,
                                        device_type=args.device_type)
                save_record(rec, args.tag, args.results_dir)
                status = rec["status"]
                extra = (f" flops={rec['cost_analysis'].get('flops', 0):.3g}"
                         if status == "ok" else
                         f" {rec.get('reason', rec.get('error', ''))[:70]}")
                print(f"[{status:7s}] {arch:22s} {shape:12s} roofline "
                      f"{rec.get('total_s', 0):7.1f}s{extra}", flush=True)
                n_fail += status == "failed"
                continue
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp, quant=args.quant,
                               compile_=not args.no_compile, tag=args.tag,
                               device_type=args.device_type)
                save_record(rec, args.tag, args.results_dir)
                status = rec["status"]
                if status == "ok":
                    c = rec["collectives"]
                    extra = (f" coll={sum(c['counts'].values())}"
                             f"/{c['total_bytes']:.4g}B")
                    if "cost_analysis" in rec:
                        extra += f" flops={rec['cost_analysis']['flops']:.4g}"
                else:
                    extra = f" reason={rec.get('reason', rec.get('error'))[:80]}"
                print(f"[{status:7s}] {arch:22s} {shape:12s} "
                      f"{rec['mesh']:6s} {rec.get('total_s', 0):7.1f}s{extra}",
                      flush=True)
                n_fail += status == "failed"
    print(f"dry-run complete, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
