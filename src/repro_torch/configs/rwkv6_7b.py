"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf].
Runs long_500k (O(1)/token state)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, norm="layernorm", pos="none", rwkv_head_dim=64,
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=128, vocab=256, rwkv_head_dim=8, dtype="float32")
