"""ZeRO-1 moment partitioning and gradient-compression hooks.

Counterpart of ``repro/parallel/zero.py``: :func:`state_spec` adds the
data axis to a parameter's spec for its AdamW moments (the first
unsharded dim that divides, else an already-sharded dim that divides
further), so each data rank keeps and updates only its part of the
moments; ``train/step.py`` all-gathers the updated parameter parts over
``data``.  Under ``grad_reduce_dtype="bf16"`` each microbatch's reduced
gradients are rounded to bf16 before the fp32 sum (:func:`compress_grads`),
as the JAX package rounds the cross-data-axis reduction payload.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def state_spec(param_spec: Optional[Tuple], shape: Sequence[int], data_axes: Sequence[str],
               sizes: Dict[str, int]) -> Tuple:
    """Moment spec = param spec (+ data axis on the first shardable dim).
    Specs are tuples of entries (None, an axis, or a tuple of axes)."""
    param_spec = tuple(param_spec or ())
    if not data_axes:
        return param_spec
    used = set()
    for e in param_spec:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    if any(a in used for a in data_axes):
        return param_spec
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    dsize = 1
    for a in data_axes:
        dsize *= sizes[a]
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0 and dim >= dsize:
            entries[i] = data_axes[0] if len(data_axes) == 1 else tuple(data_axes)
            return tuple(entries)
        if e is not None:
            cur = e if isinstance(e, tuple) else (e,)
            csize = 1
            for a in cur:
                csize *= sizes[a]
            if dim % (csize * dsize) == 0:
                entries[i] = tuple(cur) + tuple(data_axes)
                return tuple(entries)
    return param_spec


def data_dim(param_spec: Tuple, moment_spec: Tuple) -> Optional[int]:
    """The dim along which the moments split a rank's parameter block over
    ``data`` (None when they do not): the data axis is added last in its
    entry, so the moment block is chunk ``data_index`` of the parameter
    block along that dim."""
    p = tuple(param_spec) + (None,) * (len(moment_spec) - len(param_spec))
    for i, (a, b) in enumerate(zip(p, moment_spec)):
        if a != b:
            return i
    return None


def compress_grads(grads: Sequence[torch.Tensor], dtype_name: str):
    if dtype_name == "fp32":
        return list(grads)
    if dtype_name == "bf16":
        return [g.to(torch.bfloat16) for g in grads]
    raise KeyError(dtype_name)
