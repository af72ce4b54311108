"""End-to-end QAT training script on the PyTorch port.

Trains an LM with QONNX fake-quant (paper technique as first-class feature):
data pipeline -> QAT train loop -> checkpoints -> resume -> loss curve.

Defaults are the reference's: W4A8, 200 steps of 16 x 32 tokens on
qwen2's SMOKE config widened to d 128 / f 256 / 4 layers (~0.5M
parameters).  ``--full`` trains the published config (qwen2-1.5B: 28
layers, d 1536, vocab 151936) with the same script:

  python examples_torch/train_qat_lm.py --full --steps 300 \\
      --global-batch 16 --seq 32

Flags: the reference's (``--wbits`` / ``--abits`` pick the recipe, 0 =
float baseline for comparison), plus ``--device`` (CUDA by default;
without CUDA the example raises rather than falling back to the CPU).
The step reaches no kernel: the fake quant runs through the STE in plain
PyTorch, and a differentiated attention runs ``chunked_attention``.

The default ``--ckpt-dir`` is ``repro_torch_qat_ckpt`` in the temporary
directory (``/tmp/repro_torch_qat_ckpt`` unless ``TMPDIR`` names another),
not the reference's ``/tmp/repro_qat_ckpt``: a rerun resumes from this
script's own latest checkpoint, never from a JAX one.  ``run(args,
state)`` takes the initial train state from its caller.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.data import SyntheticLMStream, to_device
from repro_torch.dist.fault import Watchdog
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.train.loop import TrainHyper, init_train_state, make_train_step


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="examples_torch/train_qat_lm.py")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--wbits", type=float, default=4)
    ap.add_argument("--abits", type=float, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_qat_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(cfg, hyper) as the reference builds them."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    recipe = QuantRecipe.w_a(args.wbits, args.abits) if args.wbits else FP32
    cfg = cfg.replace(quant=recipe)
    # widen the smoke model a bit so the task is non-trivial
    if args.smoke:
        cfg = cfg.replace(d_model=128, d_ff=256, n_layers=4)
    hyper = TrainHyper(peak_lr=args.lr, warmup_steps=20,
                       total_steps=args.steps, z_loss=1e-4,
                       moe_aux_weight=0.01 if cfg.family == "moe" else 0.0)
    return cfg, hyper


def run(args, state=None) -> dict:
    """Train from ``state`` (default: the seeded init on ``--device``),
    or from the checkpoint directory's latest step with the stream's
    state; returns {"arch", "recipe", "params", "start", "steps",
    "losses" (step -> loss), "seconds", "tok_per_s", "stragglers"}."""
    dev = resolve_device(args.device)
    cfg, hyper = build(args)
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=args.global_batch,
                               seq_len=args.seq, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    wd = Watchdog()

    if state is None:
        state = init_train_state(0, cfg, hyper, dev)
    # resume if a checkpoint exists (fault-tolerant restart path)
    latest = mgr.latest_step()
    if latest is not None:
        print(f"resuming from checkpoint step {latest}")
        mgr.restore(latest, state)
        stream.load_state_dict(mgr.manifest(latest)["extra"])

    step_fn = make_train_step(cfg, hyper)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} recipe={cfg.quant.tag()} params={n_params / 1e6:.1f}M "
          f"batch={args.global_batch}x{args.seq}")

    t_start = time.time()
    start = int(state["step"])
    losses = {}
    for i in range(start, args.steps):
        with wd.step(i):
            state, m = step_fn(state, to_device(stream.next(), dev))
        losses[i + 1] = m["loss"]
        if (i + 1) % 20 == 0 or i == start:
            print(f"step {i + 1:4d} loss={float(m['loss']):.4f} "
                  f"nll={float(m['nll']):.4f} lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f}")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, extra=stream.state_dict())
    mgr.wait()
    losses = {k: float(v) for k, v in losses.items()}     # ends on the device's work
    dt = time.time() - t_start
    toks = (args.steps - start) * args.global_batch * args.seq
    print(f"done: {dt:.1f}s, {toks / max(dt, 1e-9):.0f} tok/s, "
          f"stragglers={len(wd.stragglers)}")
    return {"arch": cfg.name, "recipe": cfg.quant.tag(), "params": n_params,
            "start": start, "steps": args.steps, "losses": losses, "seconds": dt,
            "tok_per_s": toks / max(dt, 1e-9), "stragglers": list(wd.stragglers)}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
