"""minicpm3-4b — MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.config import MLAConfig, ModelConfig, register

FULL = ModelConfig(
    name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73_448,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE = FULL.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                    d_ff=128, vocab_size=128,
                    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=8, qk_rope_head_dim=4,
                                  v_head_dim=8))

register(FULL, SMOKE)
