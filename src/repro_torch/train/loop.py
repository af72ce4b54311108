"""Training step builder: loss, microbatch accumulation, optimizer glue
(counterpart of ``repro.train.loop``).

``make_train_step(cfg, hyper)`` returns a (state, batch) -> (state,
metrics) function.  Features, as the reference's:

  * causal-LM cross-entropy in float32 with z-loss (logit drift control)
  * the MoE load-balance term (``moe_aux``, weighted by ``moe_aux_weight``)
  * the VLM image-prefix positions sliced off the logits
  * gradient accumulation over ``hyper.microbatches``, in float32
  * optional error-feedback int8 gradient compression (paper's Quant op)
  * the cosine schedule, then AdamW (``optim/``)

The state is ``{"params": model, "opt": AdamWState, "step": int32 0-d
[, "compress": CompressState]}``; ``model`` is the ``nn.Module`` of
``models.api`` with gradients on, and the moments are dicts keyed by its
parameter names.  Unlike the reference's pure function, a step updates
the parameters and moments in place and returns the state with its new
counters.  It runs on device tensors only (lr, the clip factor, the bias
corrections and the step are device tensors; nothing is read back to the
host and no Python branch depends on a device value), so a caller reads
the metrics when it wants them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.executor import resolve_device
from repro_torch.dist.sharding import distribute, distribute_model, param_pspecs, to_shardings
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, dtensor_scope, is_dtensor
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compress import CompressState, compress_init, compressed_grads
from repro_torch.optim.schedule import cosine_schedule


@dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    z_loss: float = 1e-4
    moe_aux_weight: float = 0.01
    microbatches: int = 1
    compress_grads: bool = False


def loss_fn(params, batch, cfg: ModelConfig, hyper: TrainHyper):
    """(loss, {"nll", "z_loss", "moe_aux"}), 0-d float32 tensors.  The vlm
    family's logits lose their first ``cfg.n_patches`` positions (the
    image prefix), as the reference's do.  The gold logit is gathered
    (the reference takes the same value by a masked sum over the
    vocabulary, a choice for its sharded logits)."""
    logits, aux = api.forward(params, batch, cfg)       # (B, S_total, V) float32
    n_prefix = api.n_prefix(cfg)
    if n_prefix:
        logits = logits[:, n_prefix:]
    if is_dtensor(logits):
        lse, gold = _sharded_lse_gold(logits, batch["labels"])
    else:
        labels = torch.as_tensor(batch["labels"], device=logits.device).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold).mean()
    zl = hyper.z_loss * torch.square(lse).mean()
    moe = hyper.moe_aux_weight * aux["moe_aux"]
    return nll + zl + moe, {"nll": nll, "z_loss": zl, "moe_aux": aux["moe_aux"]}


def _sharded_lse_gold(logits, labels):
    """logsumexp and the gold logit of vocab-sharded DTensor logits, as
    the reference computes them for its sharded logits: the max, the sum
    of exponentials and a masked sum over the vocabulary, each reduced
    over the model axis (a gather or ``logsumexp`` across the shards would
    all-gather the logits)."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == labels[..., None].long()
    gold = torch.sum(torch.where(hit, logits, torch.zeros((), device=logits.device)), dim=-1)
    return lse, gold


def microbatch(v, n: int, i: int):
    """Microbatch i of n of a batch leaf: rows i·B/n .. (i+1)·B/n of a
    plain tensor, as the reference's split.  A DTensor sharded on its
    batch dim keeps each rank's rows on that rank: microbatch i takes the
    i-th n-th of every rank's rows (rows r·n + i), with no communication.
    The microbatches then group other rows than the reference's, which
    changes what depends on a microbatch's rows together: a dynamic
    per-tensor activation scale, MoE capacity drops and load-balance
    loss, the last microbatch's reported loss (ROADMAP C23).  Where the
    loss is a mean of per-row terms, the accumulated gradient is the same
    sum."""
    rest = tuple(v.shape[1:])
    if is_dtensor(v):
        return v.reshape((v.shape[0] // n, n) + rest)[:, i]
    return v.reshape((n, v.shape[0] // n) + rest)[i]


def init_train_state(rng, cfg: ModelConfig, hyper: TrainHyper, device=None) -> dict:
    """Seeded parameters (``api.init_params``) with gradients on, zero
    moments, step 0, on ``device`` (CUDA unless given another)."""
    params = api.init_params(rng, cfg, resolve_device(device)).requires_grad_(True)
    named = dict(params.named_parameters())
    state = {"params": params, "opt": adamw_init(named),
             "step": torch.zeros((), dtype=torch.int32, device=params.embed.device)}
    if hyper.compress_grads:
        state["compress"] = compress_init(named)
    return state


def place_train_state(state: dict, mesh) -> dict:
    """The whole train state placed over ``mesh`` by the reference's
    launcher rules (``param_pspecs`` with FSDP): the parameters swapped
    in place for DTensors (``distribute_model``), AdamW's ``mu`` / ``nu``
    and the compression residual each with its parameter's placement, the
    step counters replicated.  Every rank passes the same state.  A leaf
    whose stacking axis the reference's FSDP shards (rwkv6's ``w0``,
    ROADMAP C21) keeps only its model-axis placement: it is replicated
    over the data axes.  On a one-entry mesh the state as it is."""
    if mesh.size == 1:
        return state
    shardings = to_shardings(param_pspecs(state, mesh), mesh)
    distribute_model(state["params"], shardings["params"])
    out = dict(state)
    for k in state:
        if k != "params":
            out[k] = distribute(state[k], shardings[k])
    return out


def train_state_specs(cfg: ModelConfig, hyper: TrainHyper) -> dict:
    """The train state's leaves as meta-device tensors (shapes and dtypes,
    no storage), keyed as a checkpoint keys them."""
    p = api.param_specs(cfg)
    f32 = lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta")
    step = lambda: torch.empty((), dtype=torch.int32, device="meta")
    state = {"params": p,
             "opt": AdamWState(step=step(), mu={k: f32(s) for k, s in p.items()},
                               nu={k: f32(s) for k, s in p.items()}),
             "step": step()}
    if hyper.compress_grads:
        state["compress"] = CompressState(residual={k: f32(s) for k, s in p.items()})
    return state


def train_state_from_reference(tree: dict, cfg: ModelConfig, hyper: TrainHyper,
                               device=None) -> dict:
    """The reference's whole train state (its ``init_train_state`` tree or
    a step's output, numpy leaves) as the port's, on ``device`` (CUDA
    unless given another): the parameters, AdamW's ``mu`` and ``nu``
    (float32), its step and the train step counter, and the compression
    residual when ``hyper.compress_grads``."""
    device = resolve_device(device)
    params = api.params_from_reference(tree["params"], cfg, device).requires_grad_(True)
    f32 = cfg.replace(param_dtype="float32")

    def like_params(t) -> dict:
        return {k: v.detach() for k, v in
                api.params_from_reference(t, f32, device).named_parameters()}

    def int32(v) -> torch.Tensor:
        return torch.tensor(np.asarray(v), dtype=torch.int32, device=device)

    opt_step, mu, nu = tree["opt"]
    state = {"params": params,
             "opt": AdamWState(step=int32(opt_step), mu=like_params(mu),
                               nu=like_params(nu)),
             "step": int32(tree["step"])}
    if hyper.compress_grads:
        (residual,) = tree["compress"]
        state["compress"] = CompressState(residual=like_params(residual))
    return state


def decayed(named: dict) -> set:
    """The parameters AdamW decays, as the reference decides: its rule is
    ``ndim >= 2`` on leaves whose layers are stacked on a leading axis, so
    every per-layer parameter (under ``layers.``, an encoder-decoder's
    ``enc_layers.`` / ``dec_layers.``, or the hybrid's ``groups.``,
    stacked on the group axis there) counts one dimension more than the
    port's (a layer's norm weight is (L, d) there) and only the top-level
    vectors, and the hybrid's unstacked ``tail.`` vectors, escape the
    decay (ROADMAP C11)."""
    stacked = ("layers.", "enc_layers.", "dec_layers.", "groups.")
    return {k for k, p in named.items() if p.ndim + k.startswith(stacked) >= 2}


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    def grads_of(model, named: dict, batch):
        loss, metrics = loss_fn(model, batch, cfg, hyper)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: dict, batch: dict):
        # on DTensors, the backward and the update run in the models' scope
        with dtensor_scope(state["params"], batch):
            new_state, metrics = _step(state, batch)
        # the metrics as plain tensors, whole on every rank (a DTensor
        # metric may hold a pending sum, whose local value is a part)
        return new_state, {k: v.full_tensor() if is_dtensor(v) else v
                           for k, v in metrics.items()}

    def _step(state: dict, batch: dict):
        model = state["params"]
        named = dict(model.named_parameters())
        n = hyper.microbatches
        if n > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in named.values()]
            for i in range(n):
                mb = {k: microbatch(v, n, i) for k, v in batch.items()}
                # the reference's scan reports the last microbatch's loss
                loss, metrics, g = grads_of(model, named, mb)
                torch._foreach_add_(acc, list(g.values()))
            # a division by a constant, as XLA computes it (ROADMAP C7)
            grads = dict(zip(named, torch._foreach_mul(acc, 1.0 / n)))
        else:
            loss, metrics, grads = grads_of(model, named, batch)

        new_state = dict(state)
        if hyper.compress_grads:
            grads, new_state["compress"] = compressed_grads(grads, state["compress"])
        lr = cosine_schedule(state["step"], peak=hyper.peak_lr,
                             warmup_steps=hyper.warmup_steps,
                             total_steps=hyper.total_steps)
        _, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], named, lr=lr, weight_decay=hyper.weight_decay,
            max_grad_norm=hyper.max_grad_norm, decay=decayed(named))
        new_state.update(opt=new_opt, step=state["step"] + 1)
        return new_state, dict(metrics, loss=loss, lr=lr, **opt_metrics)

    return train_step
