"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the nested dict that ``repro.models.lm.init_params``
returns, after ``jax.tree.map(np.asarray, ...)`` (numpy leaves, stacked
``[L, ...]``), and returns the port's serving parameters
(``models/lm.py``); ``master_params_from_jax`` returns its training
parameters, and ``shard_master_params_from_jax`` one grid rank's blocks of
them (``gather_master_params`` is the inverse, for the tests).
bfloat16 arrays cross through a ``uint16`` view, so no JAX or ml_dtypes
import is needed here.  The trees cross leaf by leaf whatever the mixer:
an MLA model's (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``,
``wkv_b``, ``wo``) as a GQA model's.  This is what makes both packages compute the same
function in the parity tests.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit-exact; bfloat16 goes through a uint16 view."""
    a = np.array(a, order="C")           # a writable copy torch may alias
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_tensor(np.asarray(tree), device)


def params_from_jax(tree: Dict[str, Any], *, device="cuda",
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """The port's serving parameters from a numpy copy of the JAX tree."""
    return lm.prepare_params(_convert(tree, resolve_device(device)), dtype)


def master_params_from_jax(tree: Dict[str, Any], *, device="cuda") -> Dict[str, Any]:
    """The port's training parameters (the JAX form, leaves that require
    grad) from a numpy copy of the JAX tree."""
    out = _convert(tree, resolve_device(device))
    for _, t in lm.flatten(out):
        t.requires_grad_(True)
    return out


def shard_master_params_from_jax(tree: Dict[str, Any], grid, *, device="cuda",
                                 fused_loss: bool = True,
                                 strategy: str = "hecaton") -> Dict[str, Any]:
    """Rank ``grid.rank``'s blocks of the training parameters (the slices
    that ``parallel/specs.param_specs`` gives it under ``strategy``), as
    leaves that require grad."""
    from repro_torch.parallel import specs
    full = _convert(tree, resolve_device(device))
    out = specs.shard_tree(full, specs.param_specs(full, grid, fused_loss, strategy), grid)
    for _, t in lm.flatten(out):
        t.requires_grad_(True)
    return out


def gather_master_params(params: Dict[str, Any], grid, *, fused_loss: bool = True,
                         strategy: str = "hecaton") -> Dict[str, Any]:
    """The full parameters from every rank's blocks (collectives over the
    grid; every rank gets the whole tree, detached)."""
    from repro_torch.parallel import specs
    sp = specs.param_specs(params, grid, fused_loss, strategy)
    items = lm.flatten(params)
    return lm.unflatten([p for p, _ in items],
                        [specs.gather_full(t.detach(), specs.spec_of(sp, p)) for p, t in items])
