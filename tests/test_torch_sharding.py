"""The port's sharding rules, meshes and LM hooks against the reference's
(``repro.dist.sharding``, ``repro.dist.fault``, ``repro.launch.mesh``,
``repro.models.common``), on fake meshes: the rules read only a mesh's
axis names and sizes, so a mesh of 256 ``meta`` entries stands for a pod.

  * ``param_pspecs`` for every port leaf of all ten archs (their full
    configs) on {data 1, model 1}, {data 1, model 16}, {data 16, model 16}
    and {pod 2, data 16, model 16}, FSDP on and off: each equals the
    reference's spec of its stacked leaf with the stacking axis dropped.
    Read on the port's per-layer shapes instead, 50 leaves over 9 archs
    would differ; the leaves whose stacking axis FSDP shards are ROADMAP
    C21's, listed here;
  * ``batch_pspecs``, ``cache_pspecs`` and ``data_axis_size``;
    ``_leaf_name`` on dotted names and paths;
  * the LM hooks' specs (logits, residual, attention), captured from the
    reference by patching ``jax.lax.with_sharding_constraint`` and its
    mesh lookups inside the test; the hooks leave plain tensors alone;
  * ``elastic_mesh`` at patched device counts, the production and host
    meshes, and the placements a spec gives over a mesh.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as RP  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.dist import fault as r_fault  # noqa: E402
from repro.dist import sharding as rsh  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import fault  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist.sharding import Mesh, P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api, common  # noqa: E402

ARCHS = ["qwen2-1.5b", "olmo-1b", "starcoder2-3b", "starcoder2-7b", "llava-next-34b",
         "deepseek-moe-16b", "moonshot-v1-16b-a3b", "whisper-base", "rwkv6-7b",
         "recurrentgemma-2b"]
MESHES = {"1x1": {"data": 1, "model": 1}, "1x16": {"data": 1, "model": 16},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

# C21: the reference leaves whose stacking axis FSDP shards, on each of
# the four meshes (the port's per-layer specs leave that axis out): rwkv6's
# w0 (L, D), whose D the model axis takes first, so FSDP takes L
C21 = {"rwkv6-7b": {("layers", "w0")}}


def fake_mesh(shape: dict):
    """(the reference's mesh stand-in, the port's Mesh of meta entries)."""
    ref = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    devs = np.empty(tuple(shape.values()), dtype=object)
    devs.fill(torch.device("meta"))
    return ref, Mesh(devs, tuple(shape))


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


_REF_SPECS = {}


def _ref_param_specs(arch):
    if arch not in _REF_SPECS:
        _REF_SPECS[arch] = rapi.param_specs(r_get_config(arch))
    return _REF_SPECS[arch]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_references(arch, mesh_name, fsdp):
    cfg = get_config(arch)
    rmesh, tmesh_ = fake_mesh(MESHES[mesh_name])
    ref = rsh.param_pspecs(_ref_param_specs(arch), rmesh, fsdp=fsdp)
    layout = api.reference_layout(cfg)
    got = tsh.param_pspecs(api.param_shapes(cfg), tmesh_, fsdp=fsdp, layout=layout)
    assert set(got) == set(layout)
    c21 = set()
    for name, (path, shape, stacked) in layout.items():
        want = tuple(_at(ref, path))
        assert len(want) == len(shape)
        if stacked:
            if want[0] is not None:
                c21.add(tuple(path))
            want = want[1:]
        assert tuple(got[name]) == want, (name, got[name], want)
    assert c21 == (C21.get(arch, set()) if fsdp else set())


def test_stacked_rank_hazard():
    """Judged on the port's per-layer shape, qwen2's bq (1536,) would be
    replicated; the reference's stacked (28, 1536) leaf is col-parallel."""
    cfg = get_config("qwen2-1.5b")
    _, m = fake_mesh(MESHES["16x16"])
    specs = tsh.param_pspecs({"layers.3.attn.bq": (1536,)}, m,
                             layout=api.reference_layout(cfg))
    assert specs["layers.3.attn.bq"] == P("model")
    assert tsh.param_pspecs({"layers.3.attn.bq": (1536,)}, m, layout={}) \
        ["layers.3.attn.bq"] == P(None)


def test_param_pspecs_on_a_model_and_a_train_state():
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import TrainHyper, init_train_state
    cfg = get_smoke_config("qwen2-1.5b")
    _, m = fake_mesh({"data": 2, "model": 2})
    state = init_train_state(0, cfg, TrainHyper(total_steps=1), "cpu")
    specs = tsh.param_pspecs(state, m)
    flat = tsh.param_pspecs(api.param_shapes(cfg), m, layout=api.reference_layout(cfg))
    assert specs["params"] == flat
    assert specs["opt"].mu == flat and specs["opt"].nu == flat
    assert specs["step"] == P() and specs["opt"].step == P()
    with pytest.raises(ValueError, match="reference layout"):
        tsh.param_pspecs({"layers.0.attn.wq": (3, 3)}, m,
                         layout=api.reference_layout(cfg))


@pytest.mark.parametrize("path,ref_path", [
    ("layers.3.attn.bq", ("layers", 3, "attn", "bq")),
    ("groups.0.1.mix.w_in_gate", ("groups", 0, 1, "mix", "w_in_gate")),
    ("tail.2", ("tail", 2)),
    ("layers.3.attn_norm.w", ("layers", 3, "attn_norm", "w")),
    ("embed", ("embed",)),
    ("0.1", (0, 1)),
])
def test_leaf_name_on_dotted_names(path, ref_path):
    from jax.tree_util import DictKey, SequenceKey
    ref = tuple(SequenceKey(e) if isinstance(e, int) else DictKey(e) for e in ref_path)
    assert tsh._leaf_name(path) == rsh._leaf_name(ref)
    assert tsh._leaf_name(ref_path) == rsh._leaf_name(ref)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_cache_and_data_axis_size(mesh_name):
    rmesh, m = fake_mesh(MESHES[mesh_name])
    assert tsh.data_axis_size(m) == rsh.data_axis_size(rmesh)
    assert tsh._data_axes(m) == rsh._data_axes(rmesh)
    for B in (1, 16, 32, 48):
        batch = {"tokens": (B, 128), "labels": (B, 128), "img": (B, 4, 64)}
        ref = rsh.batch_pspecs({k: jax.ShapeDtypeStruct(s, np.int32)
                                for k, s in batch.items()}, rmesh)
        got = tsh.batch_pspecs(batch, m)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}
    for arch in ("qwen2-1.5b", "deepseek-moe-16b", "starcoder2-7b"):
        rcfg, cfg = r_get_config(arch), get_config(arch)
        for B in (1, 32):
            rcache = rapi.cache_specs(rcfg, B, 256)
            spec = api.cache_specs(cfg, B, 256)
            for tp in (False, True):
                ref = rsh.cache_pspecs(rcache, rmesh, tp_last_dim=tp)
                got = tsh.cache_pspecs({"k": spec["k"], "v": spec["v"]}, m,
                                       tp_last_dim=tp)
                for k in ("k", "v"):
                    assert tuple(got[k]) == tuple(ref[k])[1:], (arch, B, tp, k)


# ------------------------------------------------------------- LM hooks

HOOK_MESHES = dict(MESHES, **{"4x2": {"data": 4, "model": 2}})


def _norm_spec(spec):
    if spec is None:
        return None
    return tuple("U" if e is RP.UNCONSTRAINED or e is P.UNCONSTRAINED else e
                 for e in spec)


@pytest.fixture
def ref_hooks(monkeypatch):
    """Run the reference's hooks on a fake mesh; returns (set_mesh, seen)."""
    seen = []

    def wsc(x, spec):
        seen.append(_norm_spec(spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", wsc)
    state = {}

    def set_mesh(rmesh):
        dp = tuple(a for a in ("pod", "data") if a in rmesh.axis_names)
        monkeypatch.setattr(rcommon, "_dp_axes", lambda: (dp, rmesh))
        monkeypatch.setattr(rcommon, "_model_axis_size",
                            lambda: int(rmesh.shape.get("model", 0)))
        state["mesh"] = rmesh

    return set_mesh, seen


@pytest.mark.parametrize("mesh_name", sorted(HOOK_MESHES))
def test_lm_hook_specs_equal_the_references(mesh_name, ref_hooks):
    import jax.numpy as jnp
    set_mesh, seen = ref_hooks
    rmesh, m = fake_mesh(HOOK_MESHES[mesh_name])
    set_mesh(rmesh)
    with m:
        for shape in ((1, 1, 51865), (16, 1, 32000), (32, 7, 151936), (48, 4, 256)):
            seen.clear()
            rcommon.constrain_logits(jnp.zeros(shape, jnp.float32))
            want = seen[0] if seen else None
            assert _norm_spec(common.logits_spec(shape)) == want, shape
        for family in ("dense", "moe"):
            for on in (True, False):
                cfg = types.SimpleNamespace(shard_activations=on, family=family)
                for shape in ((1, 1, 64), (16, 32, 64), (32, 7, 64), (4, 16, 8)):
                    seen.clear()
                    rcommon.constrain_residual(jnp.zeros(shape, jnp.float32), cfg)
                    want = seen[0] if seen else None
                    assert _norm_spec(common.residual_spec(shape, cfg)) == want, \
                        (family, on, shape)
        for Sq, KV, G, hd in ((32, 2, 6, 128), (32, 16, 1, 64), (32, 2, 3, 80),
                              (7, 2, 3, 80), (1, 2, 6, 128), (1, 4, 4, 80), (16, 8, 2, 64)):
            for on in (True, False):
                seen.clear()
                qg = jnp.zeros((2, Sq, KV, G, hd), jnp.float32)
                kc = jnp.zeros((2, 1, 8, KV, hd), jnp.float32)
                rcommon._shard_attn(qg, kc, kc, Sq, KV, G, 8, on)
                got = common.attn_specs(Sq, KV, G, hd, on)
                names = ["qg", "kc", "vc"][:len(seen)]
                assert {k: _norm_spec(v) for k, v in got.items()} == \
                    dict(zip(names, seen)), (Sq, KV, G, hd, on)


def test_hooks_leave_plain_tensors_alone():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-1.5b").replace(shard_activations=True)
    _, m = fake_mesh({"data": 2, "model": 2})
    x = torch.randn(2, 4, 8)
    q = torch.randn(2, 4, 2, 2, 8)
    k = torch.randn(2, 4, 2, 8)
    with m:
        assert common.logits_spec((2, 4, 8)) == P("data", None, "model")
        assert common.constrain_logits(x) is x
        assert common.constrain_residual(x, cfg) is x
        assert all(a is b for a, b in zip(common._shard_attn(q, k, k, 4, 2, 2, True),
                                          (q, k, k)))
    assert common.logits_spec((2, 4, 8)) is None          # no ambient mesh
    assert tsh.current_mesh() is None


# ------------------------------------------------------------- meshes

@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("prefer", [1, 16])
def test_elastic_mesh_at_device_counts(n, prefer, monkeypatch):
    monkeypatch.setattr(r_fault, "jax", types.SimpleNamespace(
        device_count=lambda: n,
        make_mesh=lambda shape, axes: types.SimpleNamespace(shape=dict(zip(axes, shape)))))
    ref = r_fault.elastic_mesh(prefer_model=prefer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    got = fault.elastic_mesh(prefer_model=prefer)
    assert got.shape == ref.shape
    assert [d.index for d in got.devices.flat] == list(range(n))
    assert {d.type for d in got.devices.flat} == {"cuda"}


def test_production_and_host_meshes():
    meta = [torch.device("meta")] * 512
    m = tmesh.make_production_mesh(devices=meta)
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = tmesh.make_production_mesh(multi_pod=True, devices=meta)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert tsh.data_axis_size(m) == 32
    with pytest.raises(ValueError, match="256 devices; 255"):
        tmesh.make_production_mesh(devices=meta[:255])
    with pytest.raises(ValueError, match="512 devices; 256"):
        tmesh.make_production_mesh(multi_pod=True, devices=meta[:256])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="; 0 given or present"):
            tmesh.make_production_mesh()
    assert tmesh.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    v = tmesh.make_virtual_mesh(4, "cpu")
    assert v.shape == {"data": 4, "model": 1} and v.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(TypeError, match="Mesh"):
        tsh.mesh_argument(object())
    with pytest.raises(ValueError, match="'auto'"):
        tsh.mesh_argument("everything")
    assert tsh.mesh_argument(None) is None and tsh.mesh_argument(v) is v


def test_mesh_context_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    _, m = fake_mesh({"pod": 2, "data": 2, "model": 2})
    assert tsh.placements(P(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(P(None, "model"), m) == (Replicate(), Replicate(), Shard(1))
    U = P.UNCONSTRAINED
    assert tsh.placements(P(U, "model"), m, (Shard(0), Replicate(), Replicate())) == \
        (Shard(0), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="not an axis"):
        tsh.placements(P("expert"), m)
    one = fault.elastic_mesh(device="cpu")
    with one:
        assert tsh.current_mesh() is one
        with m:
            assert tsh.current_mesh() is m
        assert tsh.current_mesh() is one
    assert tsh.current_mesh() is None
    # a one-entry mesh needs no process group: nothing is distributed
    sh = tsh.to_shardings({"w": P(None, "model")}, one)
    assert sh["w"].device_mesh is None
    t = torch.ones(2, 2)
    assert tsh.distribute({"w": t}, sh)["w"] is t
    with pytest.raises(RuntimeError, match="process group"):
        tsh.to_shardings({"w": P()}, tmesh.make_virtual_mesh(2, "cpu"))
