"""Runs of the harness on the CPU at a tiny size, past the look for a card:
a sound run comes out correct, and a run whose served answers are altered
where the plan produces them comes out not correct, in both loops."""
import pytest

from bench import harness, manifest

Q4 = {"op": "quant", "bits": 4, "scale": 0.125, "signed": False}
TINY = {
    "name": "tiny", "image_shape": [3, 8, 8], "image_std": 0.5,
    "max_batch": 4, "pool_images": 16, "conv_gain": True,
    "reference": "bench/reference/forward.py",
    "check": {"rows": 12, "logit_rel_err_limit": 1e-3},
    "layers": [
        {"op": "quant", "bits": 8, "scale": 0.0078125, "signed": True},
        {"op": "conv", "cin": 3, "cout": 8, "k": 3, "stride": 1, "pad": 1,
         "group": 1, "w_bits": 8, "w_std": 0.1}, {"op": "relu"}, Q4,
        {"op": "conv", "cin": 8, "cout": 8, "k": 3, "stride": 1, "pad": 1,
         "group": 8, "w_bits": 4, "w_std": 0.1}, {"op": "relu"}, Q4,
        {"op": "maxpool", "k": 2, "stride": 2},
        {"op": "conv", "cin": 8, "cout": 16, "k": 1, "stride": 1, "pad": 0,
         "group": 1, "w_bits": 2, "w_std": 0.1}, {"op": "relu"}, Q4,
        {"op": "gap"}, {"op": "flatten"},
        {"op": "matmul", "cin": 16, "cout": 10, "w_bits": 4, "w_std": 0.05},
    ],
}
CELLS = {"closed": "cnv-w2a2.offline", "open": "mobilenet-w4a4.online"}
TRAFFIC = {
    "closed": {"loop": "closed", "slots_per_call": 3, "last_slot_fill": 0.5,
               "call_batches": 2, "warm_seconds": 0.1, "trace_seconds": 0.2},
    "open": {"loop": "open", "rate_per_s": 150, "window_ms": 2.0,
             "deadline_ms": 50.0, "max_queue": 256, "warm_seconds": 0.1,
             "drain_seconds": 30.0, "trace_seconds": 0.2},
}


def _run(loop, seed=2**31 + 5, traffic=None):
    """A run of the cell named for ``loop``, its configuration and mix
    replaced by the tiny ones (the cell is added where the benchmark has
    none of that name)."""
    bm = manifest.load()
    if CELLS[loop] not in {w["name"] for w in bm["workloads"]}:
        bm = dict(bm, workloads=bm["workloads"] + [
            {"name": CELLS[loop], "config": "tiny", "traffic": loop,
             "chips": 1}])
    result, _ = harness.run_cell(CELLS[loop], seed, 0.4, False,
                                 device="cpu", bm=bm, cfg=TINY,
                                 traffic=traffic or TRAFFIC[loop])
    return result


@pytest.mark.parametrize("loop", sorted(TRAFFIC))
def test_a_sound_run_is_correct(loop):
    result = _run(loop)
    assert result["correct"] is True
    assert result["attempted"] > 0
    assert result["checks"]["logit_rel_err"]["value"] <= 1e-6
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("loop", sorted(TRAFFIC))
def test_an_answer_altered_where_it_is_produced_is_caught(loop, monkeypatch):
    from repro_torch.core.compile import CompiledPlan
    call = CompiledPlan.__call__

    def altered(self, inputs, **kw):
        out = call(self, inputs, **kw)
        y = out[self.graph.output_names[0]].clone()
        y[:, 0] += 0.5 * y.abs().max() + 1.0
        return {**out, self.graph.output_names[0]: y}
    monkeypatch.setattr(CompiledPlan, "__call__", altered)
    result = _run(loop)
    assert result["correct"] is False
    assert result["checks"]["logit_rel_err"]["value"] > 1e-3


def test_a_row_of_the_padded_slot_altered_is_caught(monkeypatch):
    """Only the last, padded slot of each call served wrong: the sample
    takes half its rows from there."""
    from repro_torch.core.compile import CompiledPlan
    call = CompiledPlan.__call__
    seen = []

    def altered(self, inputs, **kw):
        out = call(self, inputs, **kw)
        x = inputs[self.graph.input_names[0]]
        padded = bool((x.reshape(x.shape[0], -1) == 0).all(dim=1).any())
        seen.append(padded)
        if not padded:
            return out
        y = -out[self.graph.output_names[0]] + 1.0
        return {**out, self.graph.output_names[0]: y}
    monkeypatch.setattr(CompiledPlan, "__call__", altered)
    result = _run("closed")
    assert any(seen) and not all(seen)
    assert result["correct"] is False


def test_a_lost_request_is_caught(monkeypatch):
    """A request the engine never completes: not correct, however right
    the answers that did come."""
    from repro_torch.serve.engine import CompiledGraphEngine, GraphRequest
    submit = CompiledGraphEngine.submit
    submitted = []

    def losing(self, x, **kw):
        submitted.append(x)
        # the warm-up submits 8 + 15; the 40th falls in the window and is
        # acknowledged but never queued
        if len(submitted) == 40:
            return GraphRequest(x)
        return submit(self, x, **kw)
    monkeypatch.setattr(CompiledGraphEngine, "submit", losing)
    result = _run("open", traffic=dict(TRAFFIC["open"], drain_seconds=1.0))
    assert result["checks"]["lost_requests"]["value"] == 1
    assert result["correct"] is False
