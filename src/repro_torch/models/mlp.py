"""Dense MLP and MoE blocks.  Counterpart of ``repro/models/mlp.py``:
``init_mlp``/``apply_mlp``, and the MoE's ``init_moe``,
``_dispatch_indices``, ``_moe_local``, ``moe_aux_losses`` and
``apply_moe`` on one device.

The MoE routes each token to its top-k experts by an fp32 router and
dispatches with the JAX package's argsort capacity rule: every expert
takes at most ``C = max(1, int(k T cf / E))`` assignments, earlier
tokens first, and the rest are dropped.  The experts' products are two
grouped launches (``PCtx.moe_gated``/``moe_mm``: every expert's
``[C, H]`` rows in one kernel), and the combine is token-major
(``PCtx.moe_combine``): each token gathers its k expert rows and sums
them in fp32 in a fixed order, where JAX scatter-adds.  The routing
(softmax, top-k, argsort, searchsorted) and the dispatch gather
(``PCtx.moe_dispatch``) stay PyTorch ops: they compute no product.

Training differentiates all of it: the router's fp32 matmul, softmax,
top-k sort and renormalisation by autograd, the grouped products, the
combine and the dispatch through their custom ops' backwards on the
kernel path (``kernels/ops.py``), none of which adds with atomics.  A
non-gated expert with an activation is trained as JAX computes it, the
product then the activation in the compute dtype.  EP x TP on the rank
grid (``mlp.py:157-214`` of the JAX package) is not ported:
``apply_moe`` refuses a grid.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def init_mlp(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] MLP parameters in fp32."""
    H, F = cfg.d_model, cfg.d_ff
    p = {"w1": L.normal_init((layers, H, F), generator),
         "w2": L.normal_init((layers, F, H), generator, scale=1.0 / F ** 0.5)}
    if L.GATED[cfg.mlp_kind]:
        p["w1b"] = L.normal_init((layers, H, F), generator)
    return p


def apply_mlp(pctx, cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return pctx.ffn(x, p["w1"], p["w2"], L.EPILOGUE_ACT[cfg.mlp_kind], p.get("w1b"))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] MoE parameters in fp32: the router [H, E] and
    the experts' weights [E, H, F] / [E, F, H].  The JAX package takes the
    fan-in of a 3-D shape from its first dim, so ``we1``/``we1b`` have std
    E^-0.5; the same here."""
    H, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": L.normal_init((layers, H, E), generator, scale=0.02),
         "we1": L.normal_init((layers, E, H, F), generator, scale=E ** -0.5),
         "we2": L.normal_init((layers, E, F, H), generator, scale=1.0 / F ** 0.5)}
    if L.GATED[cfg.mlp_kind]:
        p["we1b"] = L.normal_init((layers, E, H, F), generator, scale=E ** -0.5)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, largest first, the
    lower index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(expert_of: torch.Tensor, n_local_experts: int, e_offset: int,
                      capacity: int) -> torch.Tensor:
    """Argsort-based capacity dispatch for flattened (token, slot)
    assignments.

    expert_of: [A] global expert id per assignment (A = T * top_k).
    Returns slot_token [E_loc, C]: the assignment each slot takes, or A
    for an empty slot."""
    A = expert_of.shape[0]
    local_e = expert_of.long() - e_offset
    in_range = (local_e >= 0) & (local_e < n_local_experts)
    sort_key = torch.where(in_range, local_e, n_local_experts)        # invalid last
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    # position within its expert group
    pos = torch.arange(A, device=expert_of.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    valid = (sorted_e < n_local_experts) & (pos < capacity)
    slot = torch.where(valid, sorted_e * capacity + pos, n_local_experts * capacity)
    slot_token = torch.full((n_local_experts * capacity + 1,), A, dtype=torch.int32,
                            device=expert_of.device)
    slot_token[slot] = order.to(torch.int32)      # the dropped all land on the spare entry
    return slot_token[:-1].reshape(n_local_experts, capacity)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows per expert of a step of ``tokens`` tokens (``mlp.py:105``)."""
    mc = cfg.moe
    return max(1, int(mc.top_k * tokens * mc.capacity_factor / mc.num_experts))


def _moe_local(pctx, p, x: torch.Tensor, *, cfg: ModelConfig, n_local_experts: int,
               e_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over the tokens x [T, H] with experts [e_offset, e_offset +
    n_local).  Returns (y [T, H] in x's dtype, router probs [T, E] fp32)."""
    mc = cfg.moe
    T, H = x.shape
    k = mc.top_k
    # the router in fp32, as JAX's einsum of the compute dtype by fp32 masters
    logits = torch.matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)                                   # [T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    cap = capacity(cfg, T)
    slot_token = _dispatch_indices(idx.reshape(-1), n_local_experts, e_offset, cap)
    tok_of_slot = torch.clamp(slot_token // k, max=T - 1).long()
    slot_valid = slot_token < T * k
    slot_of = slot_of_assignments(slot_token, T * k).reshape(T, k)
    xd = pctx.moe_dispatch(x, tok_of_slot, slot_valid, slot_of)   # [E_loc, C, H]

    def local(name):
        w = p[name]
        w = w if w.shape[0] == n_local_experts else w[e_offset:e_offset + n_local_experts]
        return w.to(x.dtype)

    act = L.EPILOGUE_ACT[cfg.mlp_kind]
    if "we1b" in p:
        h = pctx.moe_gated(xd, local("we1"), local("we1b"), act)
    else:
        h = pctx.moe_mm(xd, local("we1"), act)
    yd = pctx.moe_mm(h, local("we2"))                             # [E_loc, C, H]
    y = pctx.moe_combine(yd, gate, slot_of, slot_token)
    return y, probs


def slot_of_assignments(slot_token: torch.Tensor, n_assign: int) -> torch.Tensor:
    """The inverse of :func:`_dispatch_indices`: [A] int32, each
    assignment's slot (e * C + c), or -1 where it was dropped."""
    flat = slot_token.reshape(-1).long()
    valid = flat < n_assign
    slot_of = torch.full((n_assign,), -1, dtype=torch.int32, device=slot_token.device)
    slot_of[flat[valid]] = torch.arange(flat.numel(), dtype=torch.int32,
                                        device=slot_token.device)[valid]
    return slot_of


def moe_aux_losses(probs: torch.Tensor) -> torch.Tensor:
    """Load-balance loss from router probabilities [T, E]: E * sum(me^2)
    with me the mean probability of each expert."""
    E = probs.shape[-1]
    me = probs.mean(dim=0)
    return E * torch.sum(me * me)


def apply_moe(pctx, cfg: ModelConfig, p, x: torch.Tensor):
    """x [B, S, H] -> (y [B, S, H], aux loss scalar fp32), on one device."""
    if pctx.mesh is not None:
        raise NotImplementedError(f"MoE ({cfg.name}) on the rank grid (EP x TP) is not "
                                  "ported yet; it runs on one device")
    B, S, H = x.shape
    y, probs = _moe_local(pctx, p, x.reshape(-1, H), cfg=cfg,
                          n_local_experts=cfg.moe.num_experts, e_offset=0)
    return y.reshape(B, S, H), moe_aux_losses(probs)
