"""Architecture registry: ``--arch <id>`` resolves here (counterpart of
``repro.configs``).

Each module defines CONFIG (the exact assigned configuration, a copy of
the reference's) and SMOKE (a reduced same-family config for CPU tests).
The port holds the dense, vlm, moe and audio architectures; the hybrid
and ssm ones (recurrentgemma-2b, rwkv6-7b) are not ported yet.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2_1_5b",
    "starcoder2_7b",
    "olmo_1b",
    "starcoder2_3b",
    "whisper_base",
    "recurrentgemma_2b",
    "deepseek_moe_16b",
    "moonshot_v1_16b_a3b",
    "rwkv6_7b",
    "llava_next_34b",
]
PORTED = ("qwen2_1_5b", "olmo_1b", "starcoder2_3b", "starcoder2_7b",
          "llava_next_34b", "deepseek_moe_16b", "moonshot_v1_16b_a3b", "whisper_base")

# canonical dashed ids (as listed in the assignment) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({"qwen2-1.5b": "qwen2_1_5b",
                "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"})


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP A17: the hybrid and "
            f"ssm families); ported: {', '.join(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def all_archs():
    return list(PORTED)
