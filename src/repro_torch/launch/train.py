"""Training launcher: train state, fault loop, checkpoint resume
(counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100 \\
        --global-batch 16 --seq 128 --smoke --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 3          # two gloo ranks, a (1, 2) mesh

The reference's flags, plus ``--device`` (CUDA unless given another).  It
builds the reference's configuration (``build``: W``wbits``A``abits``
fake quant, activation checkpointing unless ``--smoke``, the warmup
``min(100, steps // 10 + 1)``), resumes from the checkpoint directory's
latest step with the data stream's state, runs the steps under the
straggler ``Watchdog`` and ``run_with_restarts``, and saves every
``--ckpt-every`` steps and at the end.  As the reference, it derives
``elastic_mesh()``, logs it and runs the steps under it with
``shard_activations=True``.

One process per device: under torchrun (``--nproc-per-node N``) every
rank starts the process group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), the mesh has one entry per rank (with 2-4 ranks
``elastic_mesh(prefer_model=16)`` makes it (1, N), pure tensor
parallelism), and each rank holds its shards of the train state as
DTensors placed by ``param_pspecs`` with FSDP (``train_on``).  Without
torchrun ``--device`` names one device (a (1, 1) mesh); on a host of
several CUDA devices the launcher refuses, naming torchrun.  Run as a
script, rank 0 prints a JSON summary as its last line; the other ranks
print nothing on stdout.

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
import time

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMStream, to_device
from repro_torch.data.pipeline import place_host_batch
from repro_torch.dist.fault import RestartPolicy, Watchdog, elastic_mesh, run_with_restarts
from repro_torch.dist.sharding import data_axis_size, data_index
from repro_torch.kernels.ops import launch_counts
from repro_torch.launch.mesh import mesh_rank, torchrun_group
from repro_torch.models import api
from repro_torch.quantize.config import FP32, QuantRecipe
from repro_torch.train.loop import (TrainHyper, init_train_state, make_train_step,
                                    place_train_state)

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
    """Train; returns the summary of ``train_on``.  Under torchrun each
    process starts the group (``launch.mesh.torchrun_group``: NCCL,
    or gloo with ``--device cpu``) and trains its shards of the mesh
    ``elastic_mesh()`` derives from it; the group is destroyed at the
    end."""
    args = parse(argv)
    with torchrun_group(args.device) as rank:
        logging.basicConfig(level=logging.INFO,
                            format=f"[rank {rank}] %(levelname)s %(name)s: %(message)s")
        cfg, hyper = build(args)
        return train_on(args, cfg, hyper, elastic_mesh(device=args.device))


def train_on(args, cfg, hyper, mesh) -> dict:
    """Train ``cfg`` under ``mesh``, this process holding its entry's
    shards (``launch.mesh.mesh_rank``: a mesh of several entries needs a
    process group of one rank per entry); returns {"start", "steps",
    "mesh" (its shape), "rank", "world_size", "losses" (step -> loss of
    the last attempt's steps), "stragglers", "seconds" (the last
    attempt's steps and saves), "launches" (the kernels' launch counts)}.

    The state is placed by ``train.loop.place_train_state``; each step
    takes this rank's rows of the data stream (``n_hosts`` the data
    axes' size, ``host_index`` the rank's data coordinate, so ranks that
    differ only in their model coordinate hold the same rows) as its part
    of the global batch (``data.place_host_batch``).  ``run_with_restarts``
    retries a failed attempt in this process, from the latest checkpoint;
    a rank that dies is torchrun's to restart (``--max-restarts``), and
    every rank then resumes from that checkpoint."""
    rank = mesh_rank(mesh)
    device = mesh.devices.flat[rank]
    log.info("mesh %s over %d devices (rank %d on %s); %s (%s, remat %s)", mesh.shape,
             mesh.size, rank, device, cfg.name, cfg.quant.tag(), cfg.remat)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)

    def make_state():
        stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=args.global_batch,
                                   seq_len=args.seq, seed=0,
                                   n_hosts=data_axis_size(mesh),
                                   host_index=data_index(mesh, rank),
                                   extra_specs=frontend_specs(cfg))
        state = place_train_state(init_train_state(0, cfg, hyper, device), mesh)
        mgr.wait()                  # a save still in flight counts
        latest = mgr.latest_step()
        if latest is not None:
            log.info("resuming from step %d", latest)
            mgr.restore(latest, state)
            stream.load_state_dict(mgr.manifest(latest)["extra"])
        return {"state": state, "stream": stream}

    def run(ctx):
        state, stream = ctx["state"], ctx["stream"]
        step_fn = make_train_step(cfg, hyper)
        wd = Watchdog()
        start = int(state["step"])
        losses = {}
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            # exception-safe: a crashed step is cancelled, not recorded
            with wd.step(i), mesh:
                batch = place_host_batch(to_device(stream.next(), device), mesh)
                state, m = step_fn(state, batch)
            losses[i + 1] = m["loss"]
            if (i + 1) % 10 == 0:
                log.info("step %d loss=%.4f gnorm=%.2f", i + 1,
                         float(m["loss"]), float(m["grad_norm"]))
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                mgr.save(i + 1, state, extra=stream.state_dict())
        mgr.wait()
        seconds = time.perf_counter() - t0
        log.info("finished at step %d (stragglers flagged: %d)",
                 args.steps, len(wd.stragglers))
        return {"start": start, "steps": args.steps, "mesh": mesh.shape, "rank": rank,
                "world_size": mesh.size,
                "losses": {k: float(v) for k, v in losses.items()},
                "stragglers": list(wd.stragglers), "seconds": seconds,
                "launches": launch_counts()}

    return run_with_restarts(make_state, run,
                             RestartPolicy(max_restarts=args.max_restarts))


if __name__ == "__main__":
    summary = main()
    if summary["rank"] == 0:          # one summary line for the whole group
        print(json.dumps(summary))
