"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128, qkv_bias=True, norm="rms", ffn="swiglu",
    pos="rope", rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, dtype="float32")
