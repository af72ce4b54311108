"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attn, pattern 1 attention : 2 recurrent
[arXiv:2402.19427; hf].  Runs long_500k (sub-quadratic)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, norm="rms", ffn="swiglu", pos="rope",
    tie_embeddings=True, block_pattern=("rec", "rec", "attn"),
    lru_width=2560, window=2048, logits_softcap=30.0,
    notes="gate weights diagonal (reference: block-diagonal) — DESIGN.md",
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab=256, lru_width=64, window=8,
    dtype="float32")
