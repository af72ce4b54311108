"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling (frontend STUB: precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, norm="rms", ffn="swiglu", pos="rope",
    rope_theta=5_000_000.0, n_patches=2880,
    notes="anyres tiling stub: 5 tiles x 576 patches at d_model",
)

SMOKE = CONFIG.replace(
    name="llava-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, n_patches=6, dtype="float32")
