"""grok-1-314b — MoE 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1]

Gated MLP (3 matrices): with d_ff=32768 this yields ~316B params, matching the
advertised 314B; a non-gated MLP would undercount at ~213B."""
from repro_torch.config import MoEConfig, ModelConfig, register

FULL = ModelConfig(
    name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=32_768, vocab_size=131_072,
    mlp_kind="geglu", norm_kind="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
)

SMOKE = FULL.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=128,
                    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5))

register(FULL, SMOKE)
