"""How each rounding plan of the tensor-core SSD scan holds the kernel's
bounds, on the CPU.

    PYTHONPATH=src python3 tools/ssd_precision.py     # a few seconds

``ref.ssd_tc_emulated`` (the arithmetic of ``tc::ssd``) against
``ref.ssd_plain`` at mamba2-130m's prefill shapes (batch 1, 24 heads of
dh 64, ds 128, S = 64, 200, 512, chunk min(128, S)), from a zero and a
random initial state, on the inputs ``chip_smoke.check_ssd`` uses (a bf16
conv output from a seed, dt near 0.1, A = -(1..24)).  Plans: every fp32
operand split into bf16 hi + lo (the kernel's), and one bf16 rounding of
the scores, of x o w, or of the carried state instead.  One JSON line a
case and plan: the worst |err| / (tol + tol |want|) of y (tol 2e-2) and of
the final state (2e-4), where at most 1 passes, and how many elements of
y lie beyond their bound.
"""

import json

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

PLANS = {"split (the kernel)": {}, "scores once": dict(split_scores=False),
         "x o w once": dict(split_state=False), "state once": dict(split_h=False)}


def excess(got, want, tol):
    """|got - want| / (tol + tol |want|), elementwise."""
    got, want = got.float(), want.float()
    return (got - want).abs() / (tol + tol * want.abs())


def inputs(S, state, nh=24, dh=64, ds=128):
    gen = torch.Generator().manual_seed(S + state)
    conv = torch.randn((1, S, nh * dh + 2 * ds), generator=gen).to(torch.bfloat16)
    x = conv[..., :nh * dh].reshape(1, S, nh, dh)
    B = conv[..., nh * dh:nh * dh + ds].reshape(1, S, 1, ds)
    C = conv[..., nh * dh + ds:].reshape(1, S, 1, ds)
    dt = F.softplus(torch.randn((1, S, nh), generator=gen) - 2.5)
    A = -torch.arange(1, nh + 1, dtype=torch.float32)
    h0 = torch.randn((1, nh, dh, ds), generator=gen) if state else None
    return x, dt, A, B, C, h0


def main():
    torch.set_num_threads(4)
    for S in (64, 200, 512):
        for state in (False, True):
            x, dt, A, B, C, h0 = inputs(S, state)
            chunk = min(128, S)
            y_p, fin_p = ref.ssd_plain(x, dt, A, B, C, chunk=chunk, init_state=h0)
            for plan, kw in PLANS.items():
                y, fin = ref.ssd_tc_emulated(x, dt, A, B, C, chunk=chunk, init_state=h0, **kw)
                ey = excess(y, y_p, 2e-2)
                print(json.dumps(dict(
                    S=S, state="random" if state else "zero", plan=plan,
                    y_excess=round(ey.max().item(), 3), y_beyond=int((ey > 1).sum()),
                    y_elements=ey.numel(),
                    state_excess=round(excess(fin, fin_p, 2e-4).max().item(), 3))))


if __name__ == "__main__":
    main()
