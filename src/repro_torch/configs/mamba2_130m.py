"""mamba2-130m — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.config import ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50_280,
    norm_kind="rmsnorm", tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk_size=128),
)

SMOKE = FULL.scaled(num_layers=2, d_model=64, vocab_size=128,
                    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                                  n_groups=1, conv_kernel=4, chunk_size=8))

register(FULL, SMOKE)
