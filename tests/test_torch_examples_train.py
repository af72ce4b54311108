"""The port's ``examples_torch/train_qat_lm.py`` against the reference's
``examples/train_qat_lm.py`` on the CPU.

* From the reference's ``init_train_state(PRNGKey(0), cfg, hyper)``
  under the example's config (W4A8 on qwen2's SMOKE config widened to d
  128 / f 256 / 4 layers) carried into the port
  (``train_state_from_reference``), 3 steps of 2 x 16 tokens on the
  stream's batches: each loss within C10's rel 1e-4 of the reference's
  jitted step.
* ``--steps 4 --ckpt-every 2``, then ``--steps 6`` in the same directory,
  resumes from step 4, and its losses for steps 5-6 are bit-equal to an
  uninterrupted 6-step run.  All steps lie in the 20-step warmup, where
  the learning rate does not depend on ``--steps``.  The CPU's threaded
  scatter-adds of the backward sum in thread order, so these runs use
  torch's deterministic algorithms.

Each gate is a function that raises, and a planted-fault test shows
that it catches the fault its docstring names.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data import SyntheticLMStream as RefStream  # noqa: E402
from repro.quantize.config import QuantRecipe as RefRecipe  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from torch_examples import load, stdout_of  # noqa: E402

from repro_torch.quantize.config import QuantRecipe  # noqa: E402
from repro_torch.train import loop  # noqa: E402

STEPS, BATCH, SEQ = 3, 2, 16
LOSS_REL = 1e-4                  # C10: the QAT loss, reference vs port


def example():
    return load("examples_torch/train_qat_lm.py")


def args_for(ckpt_dir, *extra):
    return example().parse(["--device", "cpu", "--global-batch", str(BATCH), "--seq", str(SEQ),
                            "--ckpt-dir", str(ckpt_dir), *extra])


@functools.lru_cache(maxsize=None)
def reference_run():
    """The reference example's config and hyper-parameters at 2 x 16 and
    3 steps: (its initial train state as numpy, its jitted step's losses)."""
    rc = ref_smoke("qwen2-1.5b").replace(quant=RefRecipe.w_a(4, 8))
    rc = rc.replace(d_model=128, d_ff=256, n_layers=4)
    hyper = ref_loop.TrainHyper(peak_lr=3e-3, warmup_steps=20, total_steps=STEPS,
                                z_loss=1e-4, moe_aux_weight=0.0)
    state = ref_loop.init_train_state(jax.random.PRNGKey(0), rc, hyper)
    carried = jax.tree.map(np.asarray, state)
    stream = RefStream(vocab=rc.vocab, global_batch=BATCH, seq_len=SEQ, seed=0)
    step = jax.jit(ref_loop.make_train_step(rc, hyper))
    losses = {}
    for i in range(STEPS):
        state, m = step(state, jax.tree.map(jnp.asarray, stream.next()))
        losses[i + 1] = float(m["loss"])
    return carried, losses


def port_run(tmp_path, **patch):
    """The port's ``run`` from the reference's carried state; ``patch``
    replaces names of the example's module for the run."""
    mod = example()
    carried, _ = reference_run()
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        for name, value in patch.items():
            mp.setattr(mod, name, value)
        args = args_for(tmp_path, "--steps", str(STEPS))
        cfg, hyper = mod.build(args)
        state = loop.train_state_from_reference(carried, cfg, hyper, "cpu")
        lines, out = stdout_of(mod.run, args, state)
    return lines, out


def assert_losses(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), (k, got, want)


def test_train_losses_match_reference(tmp_path):
    lines, out = port_run(tmp_path)
    _, want = reference_run()
    assert_losses(out["losses"], want)
    assert out["recipe"] == "w4a8" and out["start"] == 0 and out["steps"] == STEPS
    assert lines[0] == f"arch=qwen2-smoke recipe=w4a8 params=0.5M batch={BATCH}x{SEQ}"
    assert lines[1].startswith("step    1 loss=") and lines[-1].startswith("done: ")


def test_train_gate_catches_w8a8_recipe(tmp_path):
    """Planted fault: W8A8 trained in place of the example's W4A8."""
    mod = example()
    build = mod.build

    def w8a8(args):
        cfg, hyper = build(args)
        return cfg.replace(quant=QuantRecipe.w_a(8, 8)), hyper
    _, out = port_run(tmp_path, build=w8a8)
    with pytest.raises(AssertionError):
        assert_losses(out["losses"], reference_run()[1])


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def resumed_and_whole(tmp_path, **patch):
    """(stdout of the resumed run, its losses, the uninterrupted run's)."""
    mod = example()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in patch.items():
            mp.setattr(mod, name, value)
        stdout_of(mod.run, args_for(tmp_path / "a", "--steps", "4", "--ckpt-every", "2"))
        lines, resumed = stdout_of(mod.run, args_for(tmp_path / "a", "--steps", "6"))
    _, whole = stdout_of(mod.run, args_for(tmp_path / "b", "--steps", "6"))
    return lines, resumed, whole


def assert_resumed(lines, resumed, whole):
    assert lines[0] == "resuming from checkpoint step 4"
    assert resumed["start"] == 4 and sorted(resumed["losses"]) == [5, 6]
    assert [resumed["losses"][k] for k in (5, 6)] == [whole["losses"][k] for k in (5, 6)]


def test_train_resume_bit_equal_to_uninterrupted(tmp_path, deterministic):
    lines, resumed, whole = resumed_and_whole(tmp_path)
    assert_resumed(lines, resumed, whole)
    assert (tmp_path / "a" / "step_0000000004").is_dir()
    assert not (tmp_path / "a" / "step_0000000002").exists() or \
        len(list((tmp_path / "a").glob("step_*"))) <= 2          # keep=2


def test_train_resume_gate_catches_stream_not_restored(tmp_path, deterministic):
    """Planted fault: the resume restores the train state but restarts the
    data stream from its seed."""
    from repro_torch.data import SyntheticLMStream

    class Forgetful(SyntheticLMStream):
        def load_state_dict(self, d):
            pass
    lines, resumed, whole = resumed_and_whole(tmp_path, SyntheticLMStream=Forgetful)
    with pytest.raises(AssertionError):
        assert_resumed(lines, resumed, whole)
