"""How far bf16 takes granite-moe-3b-a800m's forward from fp32, layer by
layer, with the routing held fixed, on the card.

    python3 tools/moe_bf16_gap.py            # one H100

Runs ``chip_smoke.moe_model_check``'s input (a 300-token prompt's prefill
and 8 decode steps, random weights from seed 0) at 32 and at 8 layers
through four paths: the kernels in bf16 (whose top-k choices every other
path replays, layer by layer in call order), the plain versions in bf16,
the plain versions in fp32 and the kernels in fp32.  With one routing the
paths differ only by their roundings, so the gaps show the bf16 noise
floor that the check's gates are set against.  Prints one JSON line a
depth: the card, its power limit, the logits' relative gaps (kernel and
plain bf16 against each other and against fp32, the fp32 kernel path
against the plain fp32 path) and, after each layer of the prefill, the
relative gap of the residual stream between those paths and its mean
row norm.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import blocks as BLK  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402

PATHS = (("kernel", torch.bfloat16, False), ("plain", torch.bfloat16, True),
         ("fp32", torch.float32, True), ("fp32_kernel", torch.float32, False))


def main():
    if not torch.cuda.is_available():
        print("moe_bf16_gap: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], check=True, capture_output=True, text=True).stdout.strip()
    cfg = CS.get_config(CS.MOE_ARCH)
    toks = np.random.default_rng(CS.SEED).integers(
        0, cfg.vocab_size, size=CS.MOE_CHECK_PROMPT + CS.MOE_CHECK_DECODE)
    real_top_k, real_block = MLP.top_k, BLK.apply_attn_block
    state = {"replay": None, "i": 0, "chosen": [], "hidden": None}

    def top_k(probs, k):
        if state["replay"] is not None:
            idx = state["replay"][state["i"]]
            state["i"] += 1
            return probs.gather(-1, idx), idx
        vals, idx = real_top_k(probs, k)
        state["chosen"].append(idx)
        return vals, idx

    def block(*a, **kw):
        out = real_block(*a, **kw)
        if out[0].shape[1] > 1:                   # the prefill's residual after each layer
            state["hidden"].append(out[0].float().clone())
        return out

    MLP.top_k, BLK.apply_attn_block = top_k, block
    rel = lambda a, b: float(((a - b).norm() / b.norm()).item())  # noqa: E731
    try:
        for layers in (32, 8):
            c = cfg.scaled(num_layers=layers)
            hidden, logits = {}, {}
            state["chosen"] = []
            for name, dtype, plain in PATHS:
                params = lm.init_params(c, seed=CS.SEED, device="cuda", dtype=dtype)
                state.update(replay=None if name == "kernel" else list(state["chosen"]), i=0,
                             hidden=[])
                logits[name] = CS._paged_logits(c, params, toks, CS.MOE_CHECK_PROMPT, dtype,
                                                plain)
                hidden[name] = state["hidden"]
                del params
                torch.cuda.empty_cache()
            gaps = lambda a, b: [round(rel(x, y), 5) for x, y in zip(hidden[a], hidden[b])]  # noqa
            print(json.dumps(dict(
                card=smi, layers=layers, logits=dict(
                    kernel_vs_plain=rel(logits["kernel"], logits["plain"]),
                    kernel_vs_fp32=rel(logits["kernel"], logits["fp32"]),
                    plain_vs_fp32=rel(logits["plain"], logits["fp32"]),
                    fp32_kernel_vs_fp32=rel(logits["fp32_kernel"], logits["fp32"])),
                hidden_kernel_vs_plain=gaps("kernel", "plain"),
                hidden_plain_vs_fp32=gaps("plain", "fp32"),
                hidden_kernel_vs_fp32=gaps("kernel", "fp32"),
                hidden_row_norm=[round(float(h.norm(dim=-1).mean()), 1)
                                 for h in hidden["fp32"]])), flush=True)
    finally:
        MLP.top_k, BLK.apply_attn_block = real_top_k, real_block
    return 0


if __name__ == "__main__":
    sys.exit(main())
