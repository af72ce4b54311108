"""LM generation serving: greedy decode and a slot-batched engine
(counterpart of ``repro.serve.generation``).

``greedy_generate`` runs a prompt batch through ``prefill`` (whose
attention is the flash-attention kernel B7) and then ``n_steps - 1``
``decode_step`` calls, taking the argmax token each time.
``GenerationEngine`` batches queued requests into slots of ``max_batch``,
left-pads each slot's prompts with token 0 to a common length (the pad
tokens take part in attention and in the dynamic activation scales, as in
the reference: there is no pad mask) and serves each slot with one
``greedy_generate`` call.  Everything runs eagerly on the parameters'
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
    """batch: {"tokens": (B, S_prompt)}.  Returns the generated tokens
    (B, n_steps), int32, on the parameters' device."""
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    B, S = tokens.shape
    cache_len = max(cache_len or 0, S + n_steps)
    logits, cache = api.prefill(params, {"tokens": tokens}, cfg, cache_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n_steps - 1):
        logits, cache = api.decode_step(params, cache, tok, S + i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


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
        while self.queue:
            batch = self.queue[:self.max_batch]
            self.queue = self.queue[self.max_batch:]
            S = max(int(r.prompt.shape[0]) for r in batch)
            n_steps = max(r.max_new_tokens for r in batch)
            toks = torch.zeros((len(batch), S), dtype=torch.int32)
            for i, r in enumerate(batch):            # left-pad with token 0
                toks[i, S - r.prompt.shape[0]:] = r.prompt
            out = greedy_generate(self.params, self.cfg, {"tokens": toks},
                                  n_steps=n_steps).cpu()
            for i, r in enumerate(batch):
                r.result = out[i, :r.max_new_tokens]
        return True
