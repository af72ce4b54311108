"""LM generation serving: greedy decode and a slot-batched engine
(counterpart of ``repro.serve.generation``).

``greedy_generate`` runs a prompt batch (with the modality frontend's
``img_embeds`` or ``frames`` where the family takes them) through
``prefill`` (whose causal full-prefix attention is the flash-attention
kernel B7; the ssm family has no attention and the hybrid's is windowed)
and then ``n_steps - 1`` ``decode_step`` calls, taking the argmax token
each time; the recurrent families' caches are their per-layer states.
``GenerationEngine`` batches queued requests into slots of ``max_batch``,
left-pads each slot's prompts with token 0 to a common length (the pad
tokens take part in attention and in the dynamic activation scales, as in
the reference: there is no pad mask) and serves each slot with one
``greedy_generate`` call on its tokens alone, as the reference does: a vlm
slot runs without an image, and the audio family, whose prefill needs
``frames``, cannot be served by the engine (ROADMAP C16) and raises.  Everything runs eagerly on the parameters'
device; the reference's jit cache has no counterpart.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models import api
from repro_torch.models.common import ModelConfig


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, batch: dict, n_steps: int,
                    cache_len: Optional[int] = None) -> torch.Tensor:
    """batch: {"tokens": (B, S_prompt) [, "img_embeds" | "frames"]}.
    Returns the generated tokens (B, n_steps), int32, on the parameters'
    device.  With a vlm image the cache also holds its n_patches prefix
    positions, and decoding starts after them."""
    dev = params.embed.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
             if k in ("tokens", "img_embeds", "frames")}
    B, S = batch["tokens"].shape
    n_prefix = api.n_prefix(cfg) if "img_embeds" in batch else 0
    cache_len = max(cache_len or 0, S + n_prefix + n_steps)
    logits, cache = api.prefill(params, batch, cfg, cache_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n_steps - 1):
        logits, cache = api.decode_step(params, cache, tok, S + n_prefix + i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def left_pad(prompts) -> torch.Tensor:
    """One slot's prompts, left-padded with token 0 to the longest: an
    int32 (len(prompts), S) tensor on the host."""
    prompts = [torch.as_tensor(p, dtype=torch.int32).reshape(-1) for p in prompts]
    S = max(int(p.shape[0]) for p in prompts)
    toks = torch.zeros((len(prompts), S), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, S - p.shape[0]:] = p
    return toks


@dataclass
class Request:
    prompt: torch.Tensor                 # (S,) int32
    max_new_tokens: int
    submitted: float = field(default_factory=time.monotonic)
    result: Optional[torch.Tensor] = None


class GenerationEngine:
    """Slot-based batched serving.

    Queued requests are served ``max_batch`` at a time, left-padded to a
    common prompt length, each slot as one batch: the static-batch core a
    continuous-batching scheduler would call per iteration.  Results are
    int32 tensors on the host.  ``run_pending`` serves whatever is queued.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8):
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.queue: list[Request] = []

    def submit(self, prompt, max_new_tokens: int) -> Request:
        r = Request(torch.as_tensor(prompt, dtype=torch.int32).reshape(-1),
                    int(max_new_tokens))
        self.queue.append(r)
        return r

    def run_pending(self) -> bool:
        if self.queue and self.cfg.family == "audio":
            raise ValueError(
                f"GenerationEngine serves token prompts only; {self.cfg.name} (audio) "
                "needs the batch's 'frames' for its encoder (ROADMAP C16): call "
                "greedy_generate with frames")
        while self.queue:
            batch = self.queue[:self.max_batch]
            self.queue = self.queue[self.max_batch:]
            n_steps = max(r.max_new_tokens for r in batch)
            toks = left_pad([r.prompt for r in batch])
            out = greedy_generate(self.params, self.cfg, {"tokens": toks},
                                  n_steps=n_steps).cpu()
            for i, r in enumerate(batch):
                r.result = out[i, :r.max_new_tokens]
        return True
