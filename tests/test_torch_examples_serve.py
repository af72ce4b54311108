"""The port's ``examples_torch/serve_quantized.py`` against the
reference's ``examples/serve_quantized.py`` on the CPU, section by
section on inputs carried over from the reference (its ``jax.random``
draws cannot be reproduced): calibration scales equal; prefill logits
within ``torch_lm_parity``'s rules and greedy tokens equal, in float and
under W8A8 + 8-bit KV, on the reference's ``init_params(PRNGKey(0))``;
the int8 / int4 weight-only relative errors within rel 1e-6; TFC-w2a2's
segment census equal and its served rows equal to the reference's
oracle.  The port's ``main`` also runs once end to end.

Each gate is a function that raises, and a planted-fault test shows
that it catches the fault its docstring names.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as lp  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import execute as ref_execute  # noqa: E402
from repro.core import transforms as ref_transforms  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import zoo as ref_zoo  # noqa: E402
from repro.quantize.config import QuantRecipe as RefRecipe  # noqa: E402
from repro.serve import CompiledGraphEngine as RefGraphEngine  # noqa: E402
from repro.serve import GenerationEngine as RefEngine  # noqa: E402
from repro.serve import greedy_generate as ref_greedy  # noqa: E402
from test_compile import assert_zoo_parity  # noqa: E402
from torch_examples import CPU, load, stdout_of  # noqa: E402

from repro_torch.models import api  # noqa: E402
from repro_torch.quantize.config import FP32, QuantRecipe  # noqa: E402


def _ref_config():
    return ref_smoke("qwen2-1.5b").replace(d_model=128, d_ff=256, n_layers=4)


@pytest.fixture(scope="module")
def served():
    """(reference params, port params, port cfg): the reference's
    ``init_params(PRNGKey(0), cfg)`` carried into the port."""
    sq = load("examples_torch/serve_quantized.py")
    rc, pc = _ref_config(), sq.lm_config()
    tree = jax.tree.map(np.asarray, ref_api.init_params(jax.random.PRNGKey(0), rc))
    return jax.tree.map(jnp.asarray, tree), api.params_from_reference(tree, pc, "cpu"), pc


def reference_calibration():
    """The reference's 8 samples (numpy) and its three scales on them."""
    from repro.quantize import calibrate as ref_cal
    from repro.quantize.config import TensorQuant as RefTQ
    samples = [jax.random.normal(jax.random.PRNGKey(i), (64,)) * 1.5 for i in range(8)]
    tq = RefTQ(bit_width=8)
    want = {"minmax": ref_cal.calibrate_minmax(samples, tq)[0],
            "pct99.9": ref_cal.calibrate_percentile(samples, tq, pct=99.9)[0],
            "mse": ref_cal.calibrate_mse(samples, tq)[0]}
    return [np.array(s) for s in samples], {k: float(np.asarray(v)) for k, v in want.items()}


def assert_calibration(got, want):
    """minmax and MSE equal; the percentile's at C13's bound: the port
    folds jnp.percentile's constant as XLA does, held at
    tests/test_torch_train.py's bound on the percentile statistics."""
    assert (got["minmax"], got["mse"]) == (want["minmax"], want["mse"])
    assert got["pct99.9"] == pytest.approx(want["pct99.9"], rel=2.4e-7, abs=0)


def test_serve_calibration_matches_reference():
    sq = load("examples_torch/serve_quantized.py")
    samples, want = reference_calibration()
    assert_calibration(sq.calibration([torch.from_numpy(s) for s in samples]), want)


def test_serve_calibration_gate_catches_another_percentile(monkeypatch):
    """Planted fault: the percentile calibrator clips at 99 % in place of
    99.9 %."""
    from repro_torch.quantize import calibrate
    sq = load("examples_torch/serve_quantized.py")
    samples, want = reference_calibration()
    real = calibrate.calibrate_percentile
    monkeypatch.setattr(calibrate, "calibrate_percentile",
                        lambda s, tq, pct: real(s, tq, pct=99.0))
    with pytest.raises(AssertionError):
        assert_calibration(sq.calibration([torch.from_numpy(s) for s in samples]), want)


def assert_served(port, ref, recipe: str):
    """Prefill logits within ``torch_lm_parity``'s rule for ``recipe`` and
    the greedy tokens equal."""
    lp.assert_logits(port["logits"], ref["logits"], recipe, "float32")
    np.testing.assert_array_equal(port["tokens"], ref["tokens"])


TOKENS = np.asarray([[1, 2, 3, 4, 5]], np.int32)         # step 3's batch
ref_prefill = jax.jit(ref_api.prefill, static_argnames=("cfg", "cache_len"))


def configs(pc, recipe: str):
    """(reference cfg, port cfg) of the example's model under ``recipe``:
    "fp32" (steps 2-3's float) or "w8a8kv8" (step 3's W8A8 + 8-bit KV)."""
    if recipe == "fp32":
        return _ref_config(), pc.replace(quant=FP32)
    return (_ref_config().replace(quant=RefRecipe.w_a(8, 8, kv_cache_bits=8)),
            pc.replace(quant=QuantRecipe.w_a(8, 8, kv_cache_bits=8)))


def prefill_logits(served, rc, pc):
    """(port, reference) prefill logits of step 3's batch."""
    jp, pp, _ = served
    return (api.prefill(pp, {"tokens": torch.from_numpy(TOKENS)}, pc, 13)[0],
            ref_prefill(jp, {"tokens": jnp.asarray(TOKENS)}, rc, 13)[0])


@pytest.mark.parametrize("recipe", ["fp32", "w8a8kv8"])
def test_serve_tokens_match_reference(served, recipe):
    """Step 3's greedy tokens (and, in float, step 2's engine), each
    recipe's prefill logits beside them."""
    sq = load("examples_torch/serve_quantized.py")
    jp, pp, pc = served
    rc, pc_r = configs(pc, recipe)
    if recipe == "fp32":
        prompts = [np.arange(1, 6 + i) for i in range(4)]
        eng = RefEngine(jp, rc, max_batch=4)
        want = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_pending()
        got = sq.float_serving(pp, pc, prompts)["results"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w.result))
    out = sq.quantized_serving(pp, pc, torch.from_numpy(TOKENS))
    got_logits, want_logits = prefill_logits(served, rc, pc_r)
    assert_served({"tokens": out["float" if recipe == "fp32" else "w8a8"], "logits": got_logits},
                  {"tokens": np.asarray(ref_greedy(jp, rc, {"tokens": jnp.asarray(TOKENS)},
                                                   n_steps=8)),
                   "logits": want_logits}, recipe)
    assert out["agreement"] == float((out["float"] == out["w8a8"]).mean())


def test_serve_gate_catches_float_in_place_of_w8a8(served):
    """Planted fault: the port serves the float recipe where the
    reference serves W8A8 + 8-bit KV."""
    rc, _ = configs(served[2], "w8a8kv8")
    _, pc = configs(served[2], "fp32")
    got, want = prefill_logits(served, rc, pc)
    same = np.zeros((1, 8), np.int32)
    with pytest.raises(AssertionError):
        assert_served({"tokens": same, "logits": got}, {"tokens": same, "logits": want},
                      "w8a8kv8")


WEIGHT_ONLY_REL = 1e-6


def reference_weight_only(jp):
    w = jp["layers"]["ffn"]["w_up"][0]                   # (d, f)
    x = jax.random.normal(jax.random.PRNGKey(9), (4, w.shape[0]))
    w8, s8 = ref_ops.quantize_weights_int8(w)
    w4, s4 = ref_ops.quantize_weights_int4(w)
    y_ref = x @ w
    rel = lambda y: float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref))
    return x, {"int8": rel(ref_ops.quant_matmul(x, w8, s8)),
               "int4": rel(ref_ops.quant_matmul_int4(x, w4, s4))}


def assert_weight_only(got, want):
    for k in ("int8", "int4"):
        assert got[k] == pytest.approx(want[k], rel=WEIGHT_ONLY_REL, abs=0), (k, got, want)


@pytest.fixture(scope="module")
def weight_only_ref(served):
    return reference_weight_only(served[0])


def test_serve_weight_only_matches_reference(served, weight_only_ref):
    sq = load("examples_torch/serve_quantized.py")
    _, pp, _ = served
    x, want = weight_only_ref
    w = sq.up_projection(pp)
    assert tuple(w.shape) == (128, 256)
    assert_weight_only(sq.weight_only(w, torch.from_numpy(np.array(x))), want)


def test_serve_weight_only_gate_catches_transposed_w_up(served, weight_only_ref):
    """Planted fault: layer 0's up projection read transposed (f, d), as
    a (out, in) ``nn.Linear`` weight would be, with ``x`` drawn to fit."""
    sq = load("examples_torch/serve_quantized.py")
    _, pp, _ = served
    x, want = weight_only_ref
    w = sq.up_projection(pp).T.contiguous()
    xt = torch.from_numpy(np.resize(np.asarray(x), (4, w.shape[0])))
    with pytest.raises(AssertionError):
        assert_weight_only(sq.weight_only(w, xt), want)


def _graph_samples():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(784).astype(np.float32) for _ in range(6)]


@pytest.fixture(scope="module")
def tfc_reference():
    """The reference plan's segment census and its oracle's rows."""
    g = ref_zoo.build_tfc(2, 2)
    gc = ref_transforms.cleanup(g)
    oracle = np.asarray(ref_execute(gc, {"x": np.stack(_graph_samples())})[gc.output_names[0]])
    return dict(RefGraphEngine(g, max_batch=4).plan.fused_counts), oracle


def assert_graph_serving(got, counts, oracle):
    """The census equal; each served row within the tie-flip envelope of
    the reference's oracle and, TFC-w2a2's scales being dyadic, equal to
    it (the envelope alone spans TFC's whole output range)."""
    assert got["fused_counts"] == counts
    assert len(got["results"]) == len(oracle)
    for row, want in zip(got["results"], oracle):
        assert_zoo_parity(want, row)
        np.testing.assert_array_equal(row, want)


def test_serve_graph_matches_reference(tfc_reference):
    from repro_torch.models import zoo
    sq = load("examples_torch/serve_quantized.py")
    got = sq.graph_serving(zoo.build_tfc(2, 2), _graph_samples(), "cpu")
    assert_graph_serving(got, *tfc_reference)
    assert got["maxdiff"] == 0.0          # the port's own oracle, on the CPU
    assert got["latency_p50_ms"] <= got["latency_p99_ms"]


def test_serve_graph_gate_catches_another_zoo_graph(tfc_reference):
    """Planted fault: TFC-w1a2 served in place of TFC-w2a2."""
    from repro_torch.models import zoo
    sq = load("examples_torch/serve_quantized.py")
    got = sq.graph_serving(zoo.build_tfc(1, 2), _graph_samples(), "cpu")
    with pytest.raises(AssertionError):
        assert_graph_serving(got, *tfc_reference)


def test_serve_quantized_main_runs_every_section():
    sq = load("examples_torch/serve_quantized.py")
    lines, got = stdout_of(sq.main, CPU)
    heads = ("calibration scales:", "float serving: 4 reqs", "  req0:", "  req1:",
             "W8A8+KV8 vs float: token agreement =", "weight-only matmul rel-err:",
             "compiled TFC-w2a2: segments", "graph serving: 6 reqs")
    assert len(lines) == len(heads)
    assert all(line.startswith(h) for line, h in zip(lines, heads)), lines
    assert got["graph"]["maxdiff"] == 0.0
    assert got["quantized"]["float"].shape == got["quantized"]["w8a8"].shape == (1, 8)
    assert 0 < got["weight_only"]["int8"] < got["weight_only"]["int4"] < 0.2


