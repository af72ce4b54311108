"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, norm="rms", ffn="swiglu", pos="rope",
    n_experts=64, n_shared_experts=2, top_k=6,
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=32, vocab=256, n_experts=8, n_shared_experts=1,
    top_k=2, moe_capacity_factor=2.0, dtype="float32")
