"""Arch registry of the port: importing this package registers the dense
configs the serving slice runs."""

from repro_torch.configs import (  # noqa: F401
    qwen3_0_6b,
    paper_llama,
)
