"""The comparison that decides ``correct``: rows the timed window served,
against the plain reference on the same images and arrays.

The number compared is ``logit_rel_err``: over the sampled rows, the
largest ``max |served - reference| / max |reference|`` of a row.  The
reference computes in float64, where every sum of the models' dyadic
products is exact; its control computes in bfloat16 (``dtype``).
"""
from __future__ import annotations

import importlib
from pathlib import PurePosixPath

import numpy as np
import torch

BLOCK = 16          # images a reference block holds
REFERENCE_DIR = PurePosixPath("bench/reference")


def reference(cfg: dict):
    """The module of the configuration's own reference: the file its
    ``"reference"`` key names, under ``bench/reference/``, with
    ``forward`` and ``last_codes`` as ``bench/reference/forward.py`` has
    them."""
    path = PurePosixPath(cfg["reference"])
    if path.parent != REFERENCE_DIR or path.suffix != ".py" \
            or not path.stem.isidentifier():
        raise ValueError(f"reference {cfg['reference']!r} is not a module "
                         f"file under {REFERENCE_DIR}/")
    return importlib.import_module(f"bench.reference.{path.stem}")


def reference_rows(cfg: dict, params: list, pool: torch.Tensor, index,
                   *, device, dtype=torch.float64) -> np.ndarray:
    """The reference's logits for pool images ``index`` (with repeats),
    computed once per distinct image, ``BLOCK`` images at a time."""
    forward = reference(cfg).forward
    uniq, inverse = np.unique(np.asarray(index), return_inverse=True)
    out = []
    for i in range(0, len(uniq), BLOCK):
        x = pool[torch.from_numpy(uniq[i:i + BLOCK])]
        y = forward(cfg["layers"], params, x.to(device), dtype=dtype)
        out.append(y.to(torch.float64).cpu().numpy())
    return np.concatenate(out)[inverse]


def logit_rel_err(served: np.ndarray, ref: np.ndarray) -> float:
    served = np.asarray(served, np.float64)
    scale = np.maximum(np.abs(ref).max(axis=1), np.finfo(np.float64).tiny)
    return float((np.abs(served - ref).max(axis=1) / scale).max())
