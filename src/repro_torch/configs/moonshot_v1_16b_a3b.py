"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (kimi/moonlight lineage: DeepSeekMoE-style
fine-grained with 2 shared experts) [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, norm="rms", ffn="swiglu", pos="rope",
    n_experts=64, n_shared_experts=2, top_k=6,
)

SMOKE = CONFIG.replace(
    name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256, n_experts=8, n_shared_experts=1, top_k=2,
    moe_capacity_factor=2.0, dtype="float32")
