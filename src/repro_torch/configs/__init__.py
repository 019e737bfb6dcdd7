"""Arch registry of the port: importing this package registers the dense
(GQA and MLA), MoE and SSM configs the ported slices run."""

from repro_torch.configs import (  # noqa: F401
    qwen3_0_6b,
    paper_llama,
    mamba2_130m,
    minicpm3_4b,
    granite_moe_3b_a800m,
    grok_1_314b,
)
