"""Carry model weights between the JAX package and the port.

Both packages keep one parameter layout (``wq`` is ``(d_model,
d_model)`` and used as ``h @ wq``; see models/transformer.py), so
conversion is a leaf-for-leaf copy that keeps names, nesting, shapes and
dtypes. The JAX side is handed over as numpy arrays (``np.asarray`` of
each leaf), so this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same 16 bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(tree, device="cpu"):
    """A JAX parameter pytree (dicts and lists of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) -> the same nesting of torch
    tensors on ``device``, dtypes and layouts unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf_to_torch(tree, device)


def params_to_jax(params):
    """The inverse of :func:`params_from_jax`: torch tensors -> numpy
    arrays with the same nesting, ready for ``jnp.asarray``."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_jax(v) for v in params]
    return _leaf_to_numpy(params)
