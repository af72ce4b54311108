"""The layer-table grammar (``bench/table.py``) on the CPU: the two chain
configurations build, draw, compute and count exactly as before the
grammar could branch; a toy residual table runs through the graph, the
reference, the counts and a whole run of the harness; malformed tables
are refused; a configuration is checked against the reference it names."""
import hashlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import check, counts, harness, manifest, model, seeded, table
from bench.test_bench_faults import TRAFFIC

ROOT = Path(__file__).resolve().parent.parent
CHAINS = {n: json.loads((ROOT / f"bench/configs/{n}.json").read_text())
          for n in ("mobilenet-w4a4", "cnv-w2a2")}

# Digests taken before the grammar could branch: the graph as served
# (nodes with their names, inputs, outputs and attrs; every initializer's
# bytes) and the float64 reference logits of 4 images at 32 x 32.
FINGERPRINTS = {
    ("mobilenet-w4a4", 0): ("cf3d1f84f04e1a4b", "2f2ed5f3842dec2c"),
    ("mobilenet-w4a4", 7): ("4334bc59f8b957c8", "fb2d76c773dc93a2"),
    ("cnv-w2a2", 0): ("a94c1e5fce249398", "53fa8728242deb22"),
    ("cnv-w2a2", 7): ("0cbaa7147514a040", "4b9ece7554a53ddc"),
}
# (MACs, output shape, compulsory bytes of a max_batch slot) as before
COUNTS = {"mobilenet-w4a4": (568_740_352, (1000,), 21_500_560.0),
          "cnv-w2a2": (59_461_376, (10,), 3_541_680.0)}


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return [str(v.dtype), list(v.shape), v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def graph_digest(g) -> str:
    h = hashlib.sha256()
    for t in g.inputs + g.outputs:
        h.update(repr((t.name, t.shape, t.dtype)).encode())
    for n in g.nodes:
        h.update(json.dumps([n.op_type, n.domain, n.name, n.inputs, n.outputs,
                             {k: _jsonable(v) for k, v in n.attrs.items()}],
                            sort_keys=True).encode())
    for name in sorted(g.initializers):
        a = np.ascontiguousarray(g.initializers[name])
        h.update(repr((name, str(a.dtype), a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def logits_digest(cfg: dict, seed: int) -> str:
    small = dict(cfg, image_shape=cfg["cpu_image_shape"])
    params = seeded.draw_params(small, seed)
    x = torch.from_numpy(seeded.draw_images(small, seed, 4))
    y = check.reference(small).forward(small["layers"], params, x).numpy()
    assert y.dtype == np.float64
    return hashlib.sha256(np.ascontiguousarray(y).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name,seed", sorted(FINGERPRINTS))
def test_chain_configurations_are_unmoved(name, seed):
    cfg = CHAINS[name]
    g = model.build_graph(cfg, seeded.draw_params(cfg, seed))
    assert (graph_digest(g), logits_digest(cfg, seed)) == \
        FINGERPRINTS[name, seed]
    macs, out, nbytes = COUNTS[name]
    assert counts.macs(cfg) == macs
    assert counts.output_shape(cfg) == out
    assert counts.compulsory_bytes(cfg, cfg["max_batch"]) == nbytes


# A residual network cut to a toy: a 7x7/2 stem, a padded 3x3/2 MaxPool,
# one bottleneck block whose shortcut is a stride-2 1x1 projection and one
# identity block, BipolarQuant weights on one conv, add -> relu -> quant,
# then GAP -> flatten -> matmul.
U4 = {"op": "quant", "bits": 4, "scale": 0.125, "signed": False}
S4 = {"op": "quant", "bits": 4, "scale": 0.125, "signed": True}


def _conv(cin, cout, k, stride=1, w_bits=4, **keys):
    return {"op": "conv", "cin": cin, "cout": cout, "k": k,
            "stride": stride, "pad": k // 2, "group": 1, "w_bits": w_bits,
            "w_std": 0.1, **keys}


TOY = {
    "name": "toy-resnet", "image_shape": [3, 32, 32], "image_std": 0.5,
    "max_batch": 4, "pool_images": 16, "conv_gain": True,
    "reference": "bench/reference/forward.py",
    "check": {"rows": 12, "logit_rel_err_limit": 1e-3},
    "layers": [
        {"op": "quant", "bits": 8, "scale": 0.0078125, "signed": True},
        _conv(3, 16, 7, 2, w_bits=8), {"op": "relu"}, U4,
        {"op": "maxpool", "k": 3, "stride": 2, "pad": 1, "as": "stem"},
        _conv(16, 8, 1), {"op": "relu"}, U4,
        _conv(8, 8, 3, 2, w_bits=1), {"op": "relu"}, U4,
        _conv(8, 32, 1), dict(S4, **{"as": "main"}),
        _conv(16, 32, 1, 2, **{"in": "stem"}), S4,
        {"op": "add", "with": "main"}, {"op": "relu"},
        dict(U4, **{"as": "block1"}),
        _conv(32, 8, 1), {"op": "relu"}, U4,
        _conv(8, 8, 3), {"op": "relu"}, U4,
        _conv(8, 32, 1), S4,
        {"op": "add", "with": "block1"}, {"op": "relu"}, U4,
        {"op": "gap"}, {"op": "flatten"},
        {"op": "matmul", "cin": 32, "cout": 10, "w_bits": 4, "w_std": 0.05},
    ],
}
TOY_MACS = (16 * 16 * 16 * 3 * 49        # stem, 7x7/2 to 16 x 16
            + 8 * 8 * 8 * 16             # 1x1 reduce at 8 x 8
            + 8 * 4 * 4 * 8 * 9          # 3x3/2, bipolar weights
            + 32 * 4 * 4 * 8             # 1x1 expand
            + 32 * 4 * 4 * 16            # shortcut, 1x1/2 from the stem
            + 8 * 4 * 4 * 32 + 8 * 4 * 4 * 8 * 9 + 32 * 4 * 4 * 8
            + 32 * 10)                   # the identity block, the matmul


def test_the_toy_table_walks_as_a_graph():
    steps = table.walk(TOY["layers"], TOY["image_shape"])
    shortcut = steps[13]
    assert (shortcut.src, shortcut.shape_in) == ("stem", (16, 8, 8))
    assert steps[4].shape_out == (16, 8, 8)         # the padded pool
    adds = [s for s in steps if s.layer["op"] == "add"]
    assert [(s.other, s.shape_in) for s in adds] == \
        [("main", (32, 4, 4)), ("block1", (32, 4, 4))]
    assert steps[-1].shape_out == (10,)


def test_the_toy_graph_has_the_residual_nodes():
    params = seeded.draw_params(TOY, 0)
    g = model.build_graph(TOY, params)
    ops = [n.op_type for n in g.nodes]
    assert ops.count("Add") == 2 and ops.count("BipolarQuant") == 1
    (pool,) = [n for n in g.nodes if n.op_type == "MaxPool"]
    assert list(pool.attrs["pads"]) == [1] * 4
    stem = pool.outputs[0]
    assert sorted(n.op_type for n in g.consumers(stem)) == ["Conv", "Conv"]
    # as served: both adds and the padded pool fused by the port's rules
    fused = harness.serve(TOY, params, "cpu").fused_counts
    assert (fused["eltwise_add"], fused["quant_pool"]) == (2, 1)


@pytest.mark.parametrize("seed", (0, 7, 2**31 + 11))
def test_toy_reference_equals_the_port_oracle(seed):
    from repro_torch.core.executor import execute
    params = seeded.draw_params(TOY, seed)
    x = seeded.draw_images(TOY, seed, 3)
    g = model.build_graph(TOY, params)
    oracle = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    got = check.reference(TOY).forward(TOY["layers"], params,
                                       torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(oracle, np.float64),
                                  got.numpy())
    codes = check.reference(TOY).last_codes(TOY["layers"], params,
                                            torch.from_numpy(x))
    assert bool((codes.reshape(3, -1) != 0).any(dim=1).all())


def test_toy_counts_equal_a_hand_count_and_the_port_cost_report():
    from repro_torch.analysis.cost import infer_cost
    from repro_torch.core import transforms
    assert counts.macs(TOY) == TOY_MACS
    g = transforms.cleanup(model.build_graph(TOY, seeded.draw_params(TOY, 0)))
    assert infer_cost(g).macs == TOY_MACS
    assert counts.output_shape(TOY) == (10,)


def test_toy_runs_correct_through_the_harness(monkeypatch):
    """The port's compiled tier serves the toy on the CPU in the offline
    loop: correct, nothing lost, and the whole step's share of the peak
    reads."""
    runs, make = [], harness.Run
    monkeypatch.setattr(harness, "Run",
                        lambda *a: runs.append(make(*a)) or runs[-1])
    bm = manifest.load()
    cell = "cnv-w2a2.offline"
    result, _ = harness.run_cell(cell, 2**31 + 5, 0.4, False, device="cpu",
                                 bm=bm, cfg=TOY, traffic=TRAFFIC["closed"])
    assert result["correct"] is True
    assert result["checks"]["lost_requests"]["value"] == 0
    assert result["checks"]["logit_rel_err"]["value"] <= 1e-6
    assert result["attempted"] > 0
    (run,) = runs
    mfu = manifest.reader("mfu_pct.offline")(run)
    assert mfu > 0 and mfu == pytest.approx(
        100.0 * 2 * TOY_MACS * run.record["completed"] / run.window_s
        / counts.PEAK_INT8_OPS)


@pytest.mark.parametrize("seed", (0, 7))
def test_a_padded_pool_reads_minus_infinity_at_the_edge(seed):
    """Signed codes into a padded MaxPool: where a border window holds only
    negative values, ONNX's -inf padding and a zero padding differ.  The
    port's oracle, its compiled tier and the reference agree."""
    from repro_torch.core.executor import execute
    cfg = dict(TOY, image_shape=[3, 9, 9], layers=[
        {"op": "quant", "bits": 8, "scale": 0.0078125, "signed": True},
        {"op": "maxpool", "k": 3, "stride": 2, "pad": 1}])
    x = seeded.draw_images(cfg, seed, 4)
    g = model.build_graph(cfg, [])
    oracle = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    served = harness.serve(cfg, [], "cpu")(x)
    ref = check.reference(cfg).forward(cfg["layers"], [], torch.from_numpy(x))
    assert ref.shape == (4, 3, 5, 5)
    for got in (oracle, served):
        np.testing.assert_array_equal(np.asarray(got, np.float64),
                                      ref.numpy())
    zero_padded = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(check.reference(cfg).forward(
            cfg["layers"][:1], [], torch.from_numpy(x)), [1] * 4), 3, 2)
    assert not torch.equal(zero_padded, ref)


def _bad(i, **change):
    layers = [dict(l) for l in TOY["layers"]]
    layers[i] = {k: v for k, v in {**layers[i], **change}.items()
                 if v is not None}
    return layers


BAD = {
    "undefined name": (_bad(13, **{"in": "stem0"}), 13, "stem0"),
    "undefined add operand": (_bad(15, **{"with": "mian"}), 15, "mian"),
    "duplicate name": (_bad(17, **{"as": "main"}), 17, "main"),
    "the image renamed": (_bad(4, **{"as": "input"}), 4, "input"),
    "add of unequal shapes": (_bad(15, **{"with": "stem"}), 15, "shape"),
    "a branch read at the wrong width": (_bad(13, **{"in": "main"}), 13,
                                         "cin"),
    "unknown op": (_bad(16, op="sigmoid"), 16, "unknown op"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_a_malformed_table_is_refused_naming_the_layer(case):
    layers, index, word = BAD[case]
    cfg = dict(TOY, layers=layers)
    for read in (lambda: table.walk(layers, TOY["image_shape"]),
                 lambda: counts.macs(cfg),
                 lambda: model.build_graph(cfg, seeded.draw_params(cfg, 0)),
                 lambda: check.reference(cfg).forward(
                     layers, seeded.draw_params(cfg, 0),
                     torch.zeros(1, *TOY["image_shape"]))):
        with pytest.raises(ValueError, match=rf"layer {index} .*{word}"):
            read()


def test_rows_are_checked_against_the_reference_the_config_names(
        monkeypatch):
    """A configuration that names another file under bench/reference/ is
    computed by that module's ``forward``, not by the shared one."""
    calls = []

    def forward(layers, params, x, *, dtype=torch.float64, device=None):
        calls.append(len(x))
        return torch.full((len(x), 10), 3.0, dtype=dtype)
    own = types.ModuleType("bench.reference.toy_own")
    own.forward = forward
    monkeypatch.setitem(sys.modules, "bench.reference.toy_own", own)
    cfg = dict(TOY, reference="bench/reference/toy_own.py")
    params = seeded.draw_params(TOY, 0)
    pool = torch.from_numpy(seeded.draw_images(TOY, 0, 20))
    index = np.array([3, 1, 3, 19, 0])
    rows = check.reference_rows(cfg, params, pool, index, device="cpu")
    assert calls == [4] and rows.shape == (5, 10) and (rows == 3.0).all()
    shared = check.reference_rows(TOY, params, pool, index, device="cpu")
    assert not np.array_equal(shared, rows)


@pytest.mark.parametrize("path", ("bench/forward.py", "src/forward.py",
                                  "bench/reference/forward.txt",
                                  "bench/reference/sub/forward.py",
                                  "bench/reference/../check.py"))
def test_a_reference_outside_bench_reference_is_refused(path):
    with pytest.raises(ValueError, match="bench/reference"):
        check.reference(dict(TOY, reference=path))
