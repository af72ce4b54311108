"""Name-based sharding rules: param / batch / cache partition specs, and
the device mesh they refer to (counterpart of ``repro.dist.sharding``).

``Mesh`` is an n-d array of ``torch.device`` entries with named axes, the
counterpart of a JAX mesh.  Entries may repeat a device (four entries of
``cuda:0``, eight of ``cpu``): such a mesh is the port's counterpart of
XLA's forced virtual host devices, and a compiled plan runs one batch
shard per entry (``core/compile.py``).  ``with mesh:`` makes it the
ambient mesh of the thread, as in the reference; the LM sharding hooks
(``models/common.py``) read it.

The rules are *total*: every leaf gets a full-rank ``P`` (``None``
entries for replicated dims), decided from the leaf's *name* (the
nearest named entry of its path; positional entries defer to their named
ancestor) and rank:

  * ``embed``                      — vocab-parallel (dim 0 over "model")
  * ``lm_head``                    — col-parallel on the vocab dim
  * ``we_*`` MoE banks (L,E,d,f)   — expert-parallel (dim -3 over "model")
  * row-parallel outputs (``wo``, ``w_down``, ``w_out``, ``w_o``, ``w_cv``,
    ``ws_down``, ``w_lora_b``, ``img_proj``) — dim -2 over "model"
  * every other ``w*`` / ``b*`` matrix — col-parallel (last dim over "model")
  * vectors / norms / scalars      — replicated

A dim is only sharded when its size divides the mesh axis size, and
``fsdp=True`` additionally shards the largest still-replicated dim of
every large leaf over the data axes.

**Stacked ranks.**  The reference stacks each family's layers on a leading
axis (``layers.attn.bq`` is (L, H*hd)) and its rules read that stacked
rank; the port keeps one module per layer (``layers.3.attn.bq`` is
(H*hd,)).  So a port leaf is judged as the reference judges its stacked
leaf: ``param_pspecs`` looks the port name up in the family's
``reference_layout`` (``models.api.reference_layout``: the reference's
path and stacked shape, from the tables ``params_from_reference`` loads
with) and drops the stacking axis from the spec.  Where FSDP shards that
axis itself (ROADMAP C21), the per-layer spec has no place for it and
leaves it out (``tests/test_torch_sharding.py`` lists those leaves).

``to_shardings`` turns specs into ``(DeviceMesh, placements)`` pairs and
``distribute`` builds DTensors from them; both need a process group with
one rank per mesh entry, except on a one-entry mesh, where nothing is
distributed.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

# leaves whose second-to-last dim is the contracted (input-feature) dim:
# shard the *input* features so the matmul is row-parallel and the output
# needs one all-reduce (Megatron convention)
_ROW_PARALLEL = {"wo", "w_down", "w_out", "w_o", "w_cv", "ws_down",
                 "w_lora_b", "img_proj"}
# minimum leaf size for FSDP to bother sharding (small norms stay replicated)
_FSDP_MIN_SIZE = 1 << 16


class _Unconstrained:
    """A spec entry that leaves the dim's placement as it is."""

    def __repr__(self) -> str:
        return "P.UNCONSTRAINED"


class P(tuple):
    """A partition spec: one entry per tensor dim, each an axis name, a
    tuple of axis names (sharded over their product, major to minor),
    ``None`` (replicated) or ``P.UNCONSTRAINED``."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# --------------------------------------------------------------- the mesh

_ambient = threading.local()


class Mesh:
    """An n-d array of ``torch.device`` entries with one name per axis.

    ``shape`` is {axis: size} in axis order, ``size`` the entry count,
    ``devices`` the ndarray of entries.  Entries may repeat a device.
    ``with mesh:`` sets the thread's ambient mesh (``current_mesh``)."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            arr.flat[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a {arr.ndim}-d device array for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self._device_mesh = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh over several device types: {sorted(types)}")
        return types.pop()

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in entry order."""
        return list(dict.fromkeys(self.devices.flat))

    def __enter__(self) -> "Mesh":
        stack = getattr(_ambient, "stack", None)
        if stack is None:
            stack = _ambient.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient.stack.pop()

    def device_mesh(self, device_type: Optional[str] = None):
        """The ``torch.distributed`` DeviceMesh of this mesh's shape and
        axis names over the initialised process group, built once.

        ``device_type`` (``"cpu"`` or ``"cuda"``) is the DeviceMesh's type;
        it defaults to the entries' own and must be given for a mesh of
        ``meta`` entries (a dry-run's: ``make_production_mesh(devices=
        [meta] * 256)`` over a fake process group).  The group needs at
        least one rank per entry; entry i is rank i, so a mesh smaller
        than the group is a sub-mesh of its first ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if self._device_mesh is None:
            if not dist.is_initialized() or dist.get_world_size() < self.size:
                have = dist.get_world_size() if dist.is_initialized() else 0
                raise RuntimeError(
                    f"a DeviceMesh over {self.size} entries needs an initialised "
                    f"process group of {self.size} ranks (have {have}): "
                    f"torch.distributed.init_process_group(...)")
            kind = device_type or self.device_type
            if kind == "meta":
                raise ValueError("a mesh of meta entries needs device_type= "
                                 "('cpu' or 'cuda') for its DeviceMesh")
            ranks = torch.arange(self.size).reshape(self.devices.shape)
            self._device_mesh = DeviceMesh(kind, ranks, mesh_dim_names=self.axis_names)
        elif device_type is not None and self._device_mesh.device_type != device_type:
            raise ValueError(f"this mesh's DeviceMesh is of type "
                             f"{self._device_mesh.device_type!r}, not {device_type!r}")
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct_devices()]})"


def current_mesh() -> Optional[Mesh]:
    """The thread's ambient mesh (the innermost ``with mesh:``), or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


def mesh_argument(mesh, device=None) -> Optional[Mesh]:
    """An entry point's ``mesh=`` argument: None, a ``Mesh``, or
    ``"auto"`` for ``elastic_mesh(prefer_model=1)`` (every CUDA device
    data-parallel).  TypeError for anything else, ValueError for another
    string or when ``device`` is given too."""
    if mesh is None:
        return None
    if not isinstance(mesh, (Mesh, str)):
        raise TypeError(f"mesh must be a repro_torch.dist.sharding.Mesh, "
                        f"'auto' or None, got {type(mesh).__name__}")
    if device is not None:
        raise ValueError("pass at most one of mesh= / device=")
    if isinstance(mesh, Mesh):
        return mesh
    if mesh != "auto":
        raise ValueError(f"mesh must be a Mesh, 'auto' or None: {mesh!r}")
    from .fault import elastic_mesh
    return elastic_mesh(prefer_model=1)


# ------------------------------------------------------------------ rules

def _leaf_name(path) -> str:
    """Nearest *named* entry of a leaf's path, leaf-ward first.

    ``path`` is a dotted name (``"layers.3.attn.bq"``) or a sequence of
    entries (``("layers", "attn_norm", 0)``).  Positional entries (ints,
    or all-digit parts of a dotted name) carry no name and fall through to
    the nearest named ancestor: ``"tail.2"`` is named ``"tail"``.
    Returns ``''`` only when no entry is named."""
    parts = path.split(".") if isinstance(path, str) else list(path)
    for entry in reversed(parts):
        if isinstance(entry, int) or (isinstance(entry, str) and entry.isdigit()):
            continue
        if entry != "":
            return str(entry)
    return ""


def _axis_size(mesh, axis: str) -> int:
    return int(dict(mesh.shape)[axis])


def _data_axes(mesh) -> tuple:
    """Every non-"model" mesh axis, used jointly for batch-dim sharding."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _size_of(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _model_dim_for(name: str, shape: tuple) -> Optional[int]:
    """Which dim (if any) the model axis shards, by rule.  None = replicated."""
    nd = len(shape)
    if nd == 0:
        return None
    if name == "embed":
        return 0
    if name == "lm_head":
        return nd - 1
    if name.startswith("we_"):                 # (L, E, d, f) expert banks
        return nd - 3 if nd >= 3 else None
    if nd < 2:
        return None
    if name in _ROW_PARALLEL or name.split(".")[-1] in _ROW_PARALLEL:
        return nd - 2
    if name.startswith(("w", "b")) and nd >= 2:
        return nd - 1                          # col-parallel default
    return None


def data_axis_size(mesh) -> int:
    """Total data-parallel degree: product of the non-"model" axis sizes.

    This is how many ways ``batch_pspecs`` splits the leading batch dim:
    the compiled tier pads batches to a multiple of it and runs one shard
    per data entry."""
    size = 1
    for a in _data_axes(mesh):
        size *= _axis_size(mesh, a)
    return size


def data_index(mesh, rank: int) -> int:
    """Mesh entry ``rank``'s coordinate over the data axes (every axis not
    named "model", major to minor): which of the ``data_axis_size(mesh)``
    row blocks of a batch laid out by ``batch_pspecs`` that rank holds.
    Entries that differ only in their "model" coordinate share it."""
    coord = np.unravel_index(rank, mesh.devices.shape)
    index = 0
    for axis, c in zip(mesh.axis_names, coord):
        if axis != "model":
            index = index * _axis_size(mesh, axis) + int(c)
    return index


def _data_entry(mesh):
    axes = _data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def _rule(name: str, shape: tuple, mesh, fsdp: bool, overrides: dict,
          fsdp_exclude) -> P:
    """The reference's spec for one leaf of ``shape`` named ``name``."""
    if name in overrides:
        return overrides[name]
    model_size = _axis_size(mesh, "model") if "model" in mesh.axis_names else 1
    data_axes = _data_axes(mesh)
    data_size = data_axis_size(mesh)
    spec = [None] * len(shape)
    mdim = _model_dim_for(name, shape)
    if mdim is not None and _divides(shape[mdim], model_size):
        spec[mdim] = "model"
    if fsdp and name not in fsdp_exclude and data_axes and \
            len(shape) >= 2 and _size_of(shape) >= _FSDP_MIN_SIZE:
        # shard the largest still-replicated dim over the data axes
        cands = [(shape[d], d) for d in range(len(shape))
                 if spec[d] is None and _divides(shape[d], data_size)]
        if cands:
            _, d = max(cands)
            spec[d] = _data_entry(mesh)
    return P(*spec)


def _shape_of(leaf) -> Optional[tuple]:
    """A tensor's shape, or a shape given as a tuple of ints; else None."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and all(isinstance(d, int) for d in leaf):
        return tuple(leaf)
    return None


def _find_layout(tree):
    """The reference layout of the first model (a module with ``cfg``)
    in ``tree``, or None."""
    if isinstance(tree, torch.nn.Module):
        cfg = getattr(tree, "cfg", None)
        if cfg is None:
            return None
        from repro_torch.models import api
        return api.reference_layout(cfg)
    if isinstance(tree, dict):
        vals = tree.values()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        vals = tree
    else:
        return None
    for v in vals:
        found = _find_layout(v)
        if found is not None:
            return found
    return None


def param_pspecs(params, mesh, *, fsdp: bool = True, overrides: dict = None,
                 fsdp_exclude: tuple = (), layout: dict = None):
    """Full-rank ``P`` per leaf of a parameter tree, or of a train state.

    ``params`` is a model (an ``nn.Module``: one spec per named
    parameter), a {name: tensor or shape} dict, or a tree of them
    (dicts, named tuples: a train state's moments keyed by parameter
    name, its step); the result has the same structure, with a dict in
    place of a module.  A leaf named in the family's reference layout
    (``layout``, or the model's own, ``models.api.reference_layout``) is
    judged by its reference path and stacked shape, the stacking axis
    then dropped; any other leaf by its own name and shape.

    ``overrides``    — {leaf_name: P} taking precedence
    ``fsdp``         — additionally shard the largest replicated dim of big
                       leaves over the data axes
    ``fsdp_exclude`` — leaf names exempted from FSDP sharding
    """
    overrides = overrides or {}
    if layout is None:
        layout = _find_layout(params) or {}

    def leaf(name: str, shape: tuple) -> P:
        entry = layout.get(name)
        if entry is None:
            return _rule(_leaf_name(name), shape, mesh, fsdp, overrides,
                         fsdp_exclude)
        ref_path, ref_shape, stacked = entry
        want = tuple(ref_shape[1:]) if stacked else tuple(ref_shape)
        if want != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(shape)}, but the reference "
                             f"layout gives {tuple(ref_shape)} (stacked={stacked})")
        spec = _rule(_leaf_name(ref_path), tuple(ref_shape), mesh, fsdp,
                     overrides, fsdp_exclude)
        return P(*spec[1:]) if stacked else spec

    def walk(tree, name: str):
        if isinstance(tree, torch.nn.Module):
            return {n: leaf(n, tuple(p.shape)) for n, p in tree.named_parameters()}
        shape = _shape_of(tree)
        if shape is not None:
            return leaf(name, shape)
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v, f) for f, v in zip(tree._fields, tree)))
        raise TypeError(f"{name}: no shape in a {type(tree).__name__} leaf")

    return walk(params, "")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not isinstance(tree, P):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def batch_pspecs(batch, mesh):
    """Shard the leading (batch) dim of every batch leaf over the data axes."""
    data_size = data_axis_size(mesh)

    def rule(leaf):
        shape = _shape_of(leaf)
        spec = [None] * len(shape)
        if shape and _divides(shape[0], data_size):
            spec[0] = _data_entry(mesh)
        return P(*spec)

    return _tree_map(rule, batch)


def cache_pspecs(cache, mesh, *, tp_last_dim: bool = False):
    """KV-cache sharding.  The reference's caches are stacked (L, B, C, KV,
    hd): batch dim 1 shards over the data axes, and ``tp_last_dim``
    additionally shards the head dim over "model" (activation-sharded
    decode).  The port's caches are per layer (B, C, KV, hd), so each leaf
    is judged at its stacked rank (a leading axis of 1 prepended) and the
    spec drops it again."""
    data_size = data_axis_size(mesh)
    model_size = _axis_size(mesh, "model") if "model" in mesh.axis_names else 1

    def rule(leaf):
        shape = (1,) + _shape_of(leaf)
        spec = [None] * len(shape)
        if len(shape) >= 2 and _divides(shape[1], data_size):
            spec[1] = _data_entry(mesh)
        if tp_last_dim and len(shape) >= 3 and _divides(shape[-1], model_size):
            spec[-1] = "model"
        return P(*spec[1:])

    return _tree_map(rule, cache)


# ------------------------------------------------------------- placements

class Sharding(NamedTuple):
    """A leaf's placement over a mesh: the DeviceMesh (None on a one-entry
    mesh: nothing to distribute), one placement per mesh axis, its spec."""
    device_mesh: object
    placements: tuple
    spec: P


def placements(spec, mesh, current=None) -> tuple:
    """``Shard(d)`` / ``Replicate()`` per mesh axis for ``spec``.  A mesh
    axis named by no entry is replicated, or, where ``spec`` has an
    ``UNCONSTRAINED`` entry and ``current`` placements are given, keeps
    its current placement unless that shards a constrained dim."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for d, entry in enumerate(spec):
        if entry is None or entry is P.UNCONSTRAINED:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"{mesh.axis_names}")
            by_axis[a] = Shard(d)
    free = {d for d, e in enumerate(spec) if e is P.UNCONSTRAINED}
    out = []
    for i, a in enumerate(mesh.axis_names):
        if a in by_axis:
            out.append(by_axis[a])
        elif current is not None and isinstance(current[i], Shard) and \
                current[i].dim in free:
            out.append(current[i])
        else:
            out.append(Replicate())
    return tuple(out)


def to_shardings(pspecs, mesh):
    """P tree -> ``Sharding`` tree over ``mesh``."""
    dm = mesh.device_mesh() if mesh.size > 1 else None
    return _tree_map(lambda ps: Sharding(dm, placements(ps, mesh), ps), pspecs)


def placed(local, sharding, shape, stride=None):
    """The DTensor whose shard on this rank is ``local``, of global
    ``shape`` with ``sharding``'s placements; no communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.device_mesh, list(sharding.placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride if stride is not None else
                              torch.empty(shape, device="meta").stride())


def local_shape(shape, sharding) -> tuple:
    """This rank's shard shape of a global ``shape`` under ``sharding``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        tuple(shape), sharding.device_mesh, list(sharding.placements))
    return tuple(local)


def placed_zeros(shape, dtype, sharding, device) -> torch.Tensor:
    """Zeros of global ``shape``, this rank's shard allocated on
    ``device`` (``meta`` in a dry-run: shapes only); a plain tensor where
    ``sharding`` has no DeviceMesh."""
    if sharding.device_mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return placed(torch.zeros(local_shape(shape, sharding), dtype=dtype, device=device),
                  sharding, shape)


def gather_fsdp(t):
    """FSDP's all-gather of a parameter at its use: a DTensor's shards
    over the data axes (every mesh dim not named "model") replicated, its
    model-axis placement kept.  Its backward reduce-scatters the gradient
    back to the shards.  A plain tensor or a DTensor without data shards
    passes as it is.  ``distribute_model`` applies it where a model reads
    such a parameter."""
    from torch.distributed.tensor import Replicate, Shard
    if not _data_sharded(t):
        return t
    names = t.device_mesh.mesh_dim_names
    want = [Replicate() if isinstance(pl, Shard) and names[i] != "model" else pl
            for i, pl in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, want)


def _data_sharded(t) -> bool:
    """Whether ``t`` is a DTensor sharded over a data axis (a mesh dim
    not named "model")."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return False
    names = t.device_mesh.mesh_dim_names or ()
    return any(isinstance(pl, Shard) and names[i] != "model"
               for i, pl in enumerate(t.placements))


def reduce_partial(t):
    """A DTensor's pending sums reduced: every ``Partial`` placement made
    ``Replicate`` (a row-parallel matmul's all-reduce, as GSPMD places it
    after the matmul, or a vocab-parallel embedding's); anything else as
    it is.  On a DTensor the backward hands the input the gradient of the
    result replicated where it was partial (reduced first where it
    arrives partial itself: DTensor's own backward would rebuild the
    forward's partial type, which it cannot from another partial type)
    and contiguous (a gradient gathered from uneven shards is a view of
    a padded buffer, and a matmul's backward views it flat)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return _ReducePartial.apply(t)


def _replicated_partials(t):
    from torch.distributed.tensor import Partial, Replicate
    want = [Replicate() if isinstance(p, Partial) else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = _replicated_partials(t)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return contiguous_shards(_replicated_partials(g))


def contiguous_shards(t):
    """A DTensor whose shard on this rank is contiguous (a copy where it is
    not): DTensor reads contiguity off the global strides, so its
    ``contiguous()`` leaves a shard that is a view of a padded buffer (a
    gather of uneven shards) as it is, and a later view of it fails."""
    local = t.to_local()
    if local.is_contiguous():
        return t
    return placed(local.contiguous(), Sharding(t.device_mesh, tuple(t.placements), None),
                  t.shape, t.stride())


def distribute(tensors, shardings):
    """Tensors (a tree matching ``shardings``) -> DTensors with those
    placements; on a one-entry mesh, the tensors as placed.  Every rank
    passes the same full tensors and keeps its shard of them, with no
    communication.  A ``meta`` tensor becomes a DTensor of
    meta shards, built without communication (a dry-run's)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        if sh.device_mesh is None:
            return t
        if t.is_meta:
            return placed(torch.empty(local_shape(t.shape, sh), dtype=t.dtype,
                                      device="meta"), sh, t.shape, t.stride())
        # every rank holds the same tensor: each takes its shard, no scatter
        return distribute_tensor(t, sh.device_mesh, list(sh.placements), src_data_rank=None)

    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.named_parameters())
    if isinstance(tensors, dict):
        return {k: distribute(v, shardings[k]) for k, v in tensors.items()}
    if isinstance(tensors, tuple) and hasattr(tensors, "_fields"):
        return type(tensors)(*(distribute(t, s) for t, s in zip(tensors, shardings)))
    if isinstance(tensors, list):
        return [distribute(t, s) for t, s in zip(tensors, shardings)]
    return one(tensors, shardings)


def distribute_model(model: torch.nn.Module, shardings: dict) -> torch.nn.Module:
    """``model`` with each parameter replaced, in place, by its DTensor
    under ``shardings`` ({parameter name: Sharding}, ``to_shardings`` of
    ``param_pspecs(model, mesh)``); ``requires_grad`` is kept.  The
    models' entry points then run on the DTensors (``models/common.py``).

    The FSDP policy lives here: a parameter sharded over the data axes
    reads, as its module's attribute, all-gathered over them
    (``gather_fsdp``, whose backward reduce-scatters the gradient), so
    the models use it whole on every rank without a call of their own.
    ``named_parameters()`` and the optimizer see the shards."""
    for name, dt in distribute(model, shardings).items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        old = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(dt.detach(), requires_grad=old.requires_grad))
        if _data_sharded(dt):
            _gather_at_use(mod, leaf)
    return model


class _GatheredAtUse:
    """Mixed into a module's class by ``distribute_model``: the attribute
    of an FSDP-sharded parameter reads all-gathered (``gather_fsdp``).
    The parameter itself stays registered under its name."""

    def __getattr__(self, name):
        value = super().__getattr__(name)
        if name in self.__dict__.get("_gathered_at_use", ()):
            return gather_fsdp(value)
        return value


_GATHERING_CLASSES: dict = {}


def _gather_at_use(mod: torch.nn.Module, leaf: str) -> None:
    cls = type(mod)
    if not issubclass(cls, _GatheredAtUse):
        if cls not in _GATHERING_CLASSES:
            _GATHERING_CLASSES[cls] = type(cls.__name__, (_GatheredAtUse, cls), {})
        mod.__class__ = _GATHERING_CLASSES[cls]
        mod.__dict__["_gathered_at_use"] = set()
    mod.__dict__["_gathered_at_use"].add(leaf)


__all__ = ["Mesh", "P", "Sharding", "batch_pspecs", "cache_pspecs",
           "current_mesh", "data_axis_size", "data_index", "distribute", "distribute_model",
           "contiguous_shards", "gather_fsdp", "reduce_partial",
           "local_shape", "mesh_argument", "param_pspecs", "placed", "placed_zeros",
           "placements", "to_shardings"]
