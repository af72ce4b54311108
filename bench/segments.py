"""Device ms a timed replay spends in each class of the plan's segments,
from the program's ``plan_segment_device_ms`` histograms (one observation
a ``Segment.kind`` a timed replay, written by
``CompiledPlan.record_segment_times`` while the engine's tracer is on:
in a run, the traced slice alone).

The classes partition ``Segment.kind``:

* ``gemm``: ``quant_conv``, ``quant_conv_int4``, ``quant_conv_grouped*``
  and ``quant_matmul*`` (B1 / B2 / B5 with their conv glue);
* ``depthwise``: ``quant_conv_dw`` (B6);
* ``boundary``: ``quant_dequant`` (B4), ``bipolar_act``, ``quant_pool``,
  ``eltwise_add``, ``quant_concat``;
* ``interp``: ``interp`` (the interpreted fallback).
"""
from __future__ import annotations

from typing import Optional

BOUNDARY = ("quant_dequant", "bipolar_act", "quant_pool", "eltwise_add",
            "quant_concat")


def segment_class(kind: str) -> Optional[str]:
    """The class of a segment kind; None for a kind outside the four."""
    if kind == "interp":
        return "interp"
    if kind.startswith("quant_conv_dw"):
        return "depthwise"
    if kind.startswith(("quant_conv", "quant_matmul")):
        return "gemm"
    if kind in BOUNDARY:
        return "boundary"
    return None


def class_ms(registry, model: str, cls: str) -> Optional[float]:
    """Mean ms a timed replay of ``model`` spends in class ``cls``: the
    sum over the class's kinds of each kind's mean; None where the
    registry holds no series of the class for the model."""
    fam = registry.snapshot().get("plan_segment_device_ms")
    means = [s["sum"] / s["count"] for s in (fam or {}).get("series", ())
             if s["labels"].get("model") == model and s["count"]
             and segment_class(s["labels"].get("kind", "")) == cls]
    return sum(means) if means else None


def read_class(run, cls: str) -> Optional[float]:
    """``class_ms`` of the run's configuration from the program's default
    registry; None where the program has no such registry."""
    try:
        from repro_torch.obs import default_registry
    except ImportError:
        return None
    return class_ms(default_registry(), run.cfg["name"], cls)
