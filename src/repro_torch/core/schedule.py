"""Remat policies (paper §III-B layer fusion), per layer.

Counterpart of ``repro/core/schedule.py::remat_policy``/``apply_remat``,
with ``torch.utils.checkpoint`` (non-reentrant) in place of
``jax.checkpoint``:

* ``none``   — save everything (no recompute, most memory);
* ``fusion`` — save the outputs of the projection and FFN matmuls (the
  ``tile_matmul`` and ``gated_matmul`` custom ops of ``kernels/ops.py``,
  which a selective-checkpoint policy can name), as
  ``dots_with_no_batch_dims_saveable`` does; norms, RoPE and attention
  are recomputed in the backward;
* ``full``   — save only the block boundaries (recompute everything).

Remat changes memory, never numbers: the recomputed kernels are
deterministic, and the layers draw no random numbers.

Microbatch sizing (paper §III-B a), plain functions copied from the JAX
module: :func:`choose_microbatches` picks the microbatch count and remat
policy whose live activations fit a budget, raised until a 1F1B
pipeline's bubble is small enough (:func:`min_microbatches_for_bubble`).
It is the rule an elastic restart re-plans the microbatches by for a new
data width (``runtime/fault.py``); the JAX package's dry run calls it.
"""

from __future__ import annotations

import functools
import math

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops

POLICIES = ("none", "fusion", "full")


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops.SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(fn, policy_name: str):
    """``fn`` wrapped in the named remat policy."""
    if policy_name not in POLICIES:
        raise KeyError(f"unknown remat policy {policy_name!r}")
    if policy_name == "none":
        return fn
    kw = {}
    if policy_name == "fusion":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# live bytes per token per layer (fp32-saved dot outputs) under each remat
# policy, as a multiple of d_model elements
_REMAT_FACTOR = {"none": 24.0, "fusion": 10.0, "full": 2.5}


def min_microbatches_for_bubble(n_stages: int, max_bubble: float) -> int:
    """Smallest 1F1B microbatch count whose bubble fraction
    ``(p-1)/(m+p-1)`` is at most ``max_bubble``: ``m >= (p-1)(1-f)/f``."""
    if n_stages <= 1:
        return 1
    assert 0.0 < max_bubble < 1.0, max_bubble
    return max(1, math.ceil((n_stages - 1) * (1.0 - max_bubble) / max_bubble))


def choose_microbatches(global_batch: int, seq_len: int, d_model: int,
                        n_data_shards: int, n_token_shards: int, *, num_layers: int = 32,
                        vocab: int = 32_000, act_budget_bytes: float = 2e9,
                        bytes_per_elt: int = 2, n_stages: int = 1, max_bubble: float = 0.25):
    """(microbatch count, remat policy) whose live activations fit
    ``act_budget_bytes``: per token ``L * d_model * factor(remat)`` for the
    saved layer outputs plus ``3 * vocab`` for the loss, over the token
    shards; ``fusion`` first, then ``full``.  With ``n_stages > 1`` the
    count is raised to :func:`min_microbatches_for_bubble`.  The count
    divides the per-shard batch."""
    per_shard_batch = max(1, global_batch // n_data_shards)
    floor = min(min_microbatches_for_bubble(n_stages, max_bubble), per_shard_batch)

    def divisible(n_micro: int) -> int:
        while per_shard_batch % n_micro:
            n_micro += 1
        return min(n_micro, per_shard_batch)

    def per_token(remat):
        layer_term = num_layers * d_model * _REMAT_FACTOR[remat]
        loss_term = 3.0 * vocab
        return (layer_term + loss_term) * bytes_per_elt * 2 / n_token_shards

    for remat in ("fusion", "full"):
        tokens_budget = act_budget_bytes / per_token(remat)
        mb_samples = int(tokens_budget // seq_len)
        if mb_samples >= 1:
            n_micro = max(1, math.ceil(per_shard_batch / mb_samples), floor)
            return divisible(n_micro), remat
    return per_shard_batch, "full"
