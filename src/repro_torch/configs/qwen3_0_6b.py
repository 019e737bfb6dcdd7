"""qwen3-0.6b — dense, GQA kv=8, qk_norm, SwiGLU. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-0.6b", family="dense", num_layers=28, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=3072, vocab_size=151_936,
    head_dim=128, mlp_kind="swiglu", norm_kind="rmsnorm", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = FULL.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=128)

register(FULL, SMOKE)
