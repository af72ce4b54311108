"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865
— enc-dec, conv frontend (STUB: precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, norm="layernorm", ffn="gelu", pos="sinusoidal",
    tie_embeddings=True, n_frames=1500,
    notes="conv frontend stubbed; decoder is the LM backbone",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, n_frames=12, dtype="float32")
