"""The paper's evaluation ladder (§VI-A): Llama family with doubling hidden
size, registered with a `paper-` prefix as in the JAX package."""
from repro_torch.config import ModelConfig, register


def _llama(name, L, h, nh, nkv, ff, vocab=32_000):
    return ModelConfig(name=name, family="dense", num_layers=L, d_model=h,
                       num_heads=nh, num_kv_heads=nkv, d_ff=ff,
                       vocab_size=vocab, mlp_kind="swiglu", norm_kind="rmsnorm")


for cfg in [
    _llama("paper-tinyllama-1.1b", 22, 2048, 32, 4, 5632),
    _llama("paper-llama2-7b", 32, 4096, 32, 32, 11_008),
    _llama("paper-llama2-70b", 80, 8192, 64, 8, 28_672),
    _llama("paper-llama3.1-405b", 126, 16_384, 128, 8, 53_248, vocab=128_256),
]:
    register(cfg, cfg.scaled(num_layers=2, d_model=64, num_heads=4,
                             num_kv_heads=4, head_dim=16, d_ff=128,
                             vocab_size=128))
