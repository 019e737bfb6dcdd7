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
"""

from __future__ import annotations

import functools

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
