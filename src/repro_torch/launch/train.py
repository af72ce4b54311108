"""Training launcher: train state, fault loop, checkpoint resume
(counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100 \\
        --global-batch 16 --seq 128 --smoke --device cpu

The reference's flags, plus ``--device`` (CUDA unless given another).  It
builds the reference's configuration (``build``: W``wbits``A``abits``
fake quant, activation checkpointing unless ``--smoke``, the warmup
``min(100, steps // 10 + 1)``), resumes from the checkpoint directory's
latest step with the data stream's state, runs the steps under the
straggler ``Watchdog`` and ``run_with_restarts``, and saves every
``--ckpt-every`` steps and at the end.  As the reference, it derives
``elastic_mesh()`` over the devices present (``--device`` names one: a
(1, 1) mesh), logs it, runs the steps under it with
``shard_activations=True`` and computes the state's ``param_pspecs``
(the placement a restore would take; on one device the state stays where
it is).  A mesh of more than one device raises ``NotImplementedError``
naming ROADMAP A16b: FSDP and tensor parallelism need one process per
device.  Run as a script, it prints a JSON summary as its last line.

Every arch trains (the ssm and hybrid families through their time
loop and RG-LRU scan).  For the vlm and audio families the stream
also draws the modality frontend's stub embeddings (``img_embeds``
(n_patches, d_model) or ``frames`` (n_frames, d_model) per row, standard
normal, through the stream's ``extra_specs``), which the reference's
launcher does not pass (its vlm and audio steps then fail on the batch).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMStream, to_device
from repro_torch.dist.fault import RestartPolicy, Watchdog, elastic_mesh, run_with_restarts
from repro_torch.dist.sharding import param_pspecs
from repro_torch.models import api
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.train.loop import TrainHyper, init_train_state, make_train_step

log = logging.getLogger("repro_torch.launch.train")


def frontend_specs(cfg) -> dict:
    """The stream's ``extra_specs`` for the family's frontend stub."""
    return {name: (shape, np.float32) for name, shape in api.frontend_shapes(cfg).items()}


def build(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    recipe = QuantRecipe.w_a(args.wbits, args.abits) if args.wbits else FP32
    # shard_activations: the reference's activation-sharding constraints
    # (identities on one device)
    cfg = cfg.replace(quant=recipe, remat=not args.smoke, shard_activations=True)
    hyper = TrainHyper(
        peak_lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps, microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        moe_aux_weight=0.01 if cfg.family == "moe" else 0.0)
    return cfg, hyper


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain twins)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--wbits", type=float, default=8)
    ap.add_argument("--abits", type=float, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-restarts", type=int, default=3)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns {"start", "steps", "mesh" (its shape), "losses"
    (step -> loss of the last attempt's steps), "stragglers"}."""
    args = parse(argv)
    logging.basicConfig(level=logging.INFO)
    cfg, hyper = build(args)
    mesh = elastic_mesh(device=args.device)   # from the devices actually present
    log.info("mesh %s over %d devices; %s (%s, remat %s)", mesh.shape, mesh.size,
             cfg.name, cfg.quant.tag(), cfg.remat)
    if mesh.size > 1:
        raise NotImplementedError(
            f"training over a mesh of {mesh.size} devices {mesh.shape} needs one "
            f"process per device (ROADMAP A16b: FSDP and tensor parallelism "
            f"under torchrun by param_pspecs / to_shardings); pass --device to "
            f"train on one")
    device = mesh.devices.flat[0]
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)

    def make_state():
        stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=args.global_batch,
                                   seq_len=args.seq, seed=0,
                                   extra_specs=frontend_specs(cfg))
        state = init_train_state(0, cfg, hyper, device)
        mgr.wait()                  # a save still in flight counts
        latest = mgr.latest_step()
        # the state's placement over the mesh; on a one-device mesh every
        # spec is trivial and the state (restored in place) stays put
        pspecs = param_pspecs(state, mesh)
        if latest is not None:
            log.info("resuming from step %d", latest)
            mgr.restore(latest, state)
            stream.load_state_dict(mgr.manifest(latest)["extra"])
        return {"state": state, "stream": stream, "pspecs": pspecs}

    def run(ctx):
        state, stream = ctx["state"], ctx["stream"]
        step_fn = make_train_step(cfg, hyper)
        wd = Watchdog()
        start = int(state["step"])
        losses = {}
        for i in range(start, args.steps):
            # exception-safe: a crashed step is cancelled, not recorded
            with wd.step(i), mesh:
                state, m = step_fn(state, to_device(stream.next(), device))
            losses[i + 1] = m["loss"]
            if (i + 1) % 10 == 0:
                log.info("step %d loss=%.4f gnorm=%.2f", i + 1,
                         float(m["loss"]), float(m["grad_norm"]))
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                mgr.save(i + 1, state, extra=stream.state_dict())
        mgr.wait()
        log.info("finished at step %d (stragglers flagged: %d)",
                 args.steps, len(wd.stragglers))
        return {"start": start, "steps": args.steps, "mesh": mesh.shape,
                "losses": {k: float(v) for k, v in losses.items()},
                "stragglers": list(wd.stragglers)}

    return run_with_restarts(make_state, run,
                             RestartPolicy(max_restarts=args.max_restarts))


if __name__ == "__main__":
    print(json.dumps(main()))
