"""Minimal MLP: the simplest real gradient producer for the DP path.

Counterpart of ``akka_allreduce_tpu/models/mlp.py``: a He-initialised
dense stack with gelu between layers and a mean-squared-error loss. The
weights come from a ``torch.Generator`` (the JAX package's come from a
threefry key), so the two packages' MLPs are compared on converted
weights (``convert.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             device: "torch.device | str | None" = None) -> dict:
    """He-initialised dense stack: sizes = [in, hidden..., out];
    ``w{i}`` (d_in, d_out) normal * sqrt(2 / d_in), ``b{i}`` zeros."""
    device = device if device is not None else generator.device
    params = {}
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn(
            (d_in, d_out), generator=generator, device=device) \
            * math.sqrt(2.0 / d_in)
        params[f"b{i}"] = torch.zeros((d_out,), device=device)
    return params


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params) // 2
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            # jax.nn.gelu's default is the tanh approximation
            x = torch.nn.functional.gelu(x, approximate="tanh")
    return x


def mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    pred = mlp_apply(params, x)
    return torch.mean((pred - y) ** 2)
