"""granite-moe-3b-a800m — MoE 40 experts top-8. [hf:ibm-granite family]

The assignment lists "MoE 40e top-8" in the config line and "32 experts" in the
note; we follow the config line (40 experts, top-8).
"""
from repro_torch.config import MoEConfig, ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49_155,
    mlp_kind="swiglu", norm_kind="rmsnorm",
    moe=MoEConfig(num_experts=40, top_k=8, capacity_factor=1.25),
)

SMOKE = FULL.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=32, vocab_size=128,
                    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.5))

register(FULL, SMOKE)
