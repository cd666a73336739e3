"""Carry model weights and protocol buffers between the JAX package and
the port.

Both packages keep one parameter layout (``wq`` is ``(d_model,
d_model)`` and used as ``h @ wq``; see models/transformer.py), so
conversion is a leaf-for-leaf copy that keeps names, nesting, shapes and
dtypes. The JAX side is handed over as numpy arrays (``np.asarray`` of
each leaf), so this module needs neither JAX nor the JAX package.

:func:`buffer_state_from_numpy` carries a protocol staging buffer's
state (the numpy ring of the JAX host plane, its counts and its offset)
into the port's buffer on a device, so both engines can go on from one
mid-round state.
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


def buffer_state_from_numpy(buffer, device="cpu", into=None):
    """A JAX ``ScatteredDataBuffer`` or ``ReducedDataBuffer`` (numpy ring,
    read by duck typing) -> the port's buffer of the same kind and
    geometry on ``device``, holding the same state: the staged rows
    (``temporal_buffer``), ``count_filled``, ``total_filled``,
    ``temporal_offset`` and, for a reduced buffer,
    ``count_reduce_filled``. ``into`` (optional) is a port buffer of the
    same geometry to fill instead of a new one."""
    from akka_allreduce_tpu_torch.buffers import (ReducedDataBuffer,
                                                  ScatteredDataBuffer)
    reduced = hasattr(buffer, "count_reduce_filled")
    if into is None:
        if reduced:
            into = ReducedDataBuffer(
                buffer.max_block_size, 0, buffer.total_data_size,
                buffer.peer_size, buffer.max_lag,
                buffer.completion_threshold, buffer.max_chunk_size,
                device=device)
        else:
            into = ScatteredDataBuffer(
                buffer.data_size, buffer.peer_size, buffer.max_lag,
                buffer.reducing_threshold, buffer.max_chunk_size,
                device=device)
    ring = np.asarray(buffer.temporal_buffer, dtype=np.float32)
    if tuple(into.temporal_buffer.shape) != ring.shape \
            or into.max_chunk_size != buffer.max_chunk_size \
            or hasattr(into, "count_reduce_filled") != reduced:
        raise ValueError(f"buffer geometry differs: {ring.shape} chunk "
                         f"{buffer.max_chunk_size} into "
                         f"{tuple(into.temporal_buffer.shape)} chunk "
                         f"{into.max_chunk_size}")
    into.temporal_buffer.copy_(torch.from_numpy(ring))
    into.temporal_offset = int(buffer.temporal_offset)
    into.count_filled = np.array(buffer.count_filled, dtype=np.int64)
    into.total_filled = np.array(buffer.total_filled, dtype=np.int64)
    if reduced:
        into.count_reduce_filled = np.array(buffer.count_reduce_filled,
                                            dtype=np.int64)
    return into
