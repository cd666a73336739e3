"""The optimizer families PyTorch lacks or computes otherwise than optax.

The JAX package builds its optimizers from optax (``models/train.py
make_optimizer``: ``optax.lion``, ``optax.adafactor``, ``optax.sgd``);
optax has no counterpart inside that package, so these are written here
from optax 0.2.6's definitions, update for update:

* :class:`Lion` — ``optax.lion(lr, b1=0.9, b2=0.99, weight_decay,
  mask)``: ``u = sign((1 - b1) g + b1 mu)``, then ``mu = (1 - b2) g + b2
  mu``, then ``u + wd p`` on the decayed leaves, then ``p - lr u``.
* :class:`Adafactor` — ``optax.adafactor(learning_rate=lr,
  weight_decay_rate=wd or None, weight_decay_mask=mask)`` at optax's
  defaults: the factored second moment (``scale_by_factored_rms``: row
  and column means of ``g^2 + 1e-30`` where a leaf's two largest dims are
  both >= 128, a full second moment elsewhere) at the step-dependent
  decay ``1 - (t + 1)^-0.8``; block-RMS clipping at 1.0; the learning
  rate; the parameter-scale multiply (the leaf's RMS, at least 1e-3);
  THEN the weight decay ``+ wd p`` (after the learning rate, so not
  scaled by it); then the sign flip. ``torch.optim.Adafactor`` is
  another algorithm. A parameter that is one rank's block of a larger
  leaf (a ``tp`` / ``ep`` shard, a ``pp`` stage of stacked layers) is
  given its :class:`Shard`: the factored dims come from the whole
  leaf's shape, each row / column mean over a split dim sums over the
  line that splits it, and both block RMS (the clip and the parameter
  scale) are the whole leaf's, summed over every line that splits it,
  as optax computes them on the global array.
* :class:`SGD` — ``optax.sgd(lr, momentum=m or None, nesterov=m > 0)``:
  the trace ``t = g + m t`` from zero (so its first value is ``g``),
  the update ``g + m t`` (nesterov) or ``t``, then ``p - lr u``; no
  weight decay.

Each is a ``torch.optim.Optimizer`` (``state_dict()`` / ``load_state_dict``
as the port's checkpoint uses them). Every quantity an update reads is a
tensor on the parameters' device: the learning rate may be a float or a
0-dim tensor (``group["lr"]``), and the step count that Adafactor's decay
reads is a device tensor in the state. No update reads a value back to the
host, so a CUDA graph can capture it (``models/train.py
make_multi_step``). The state is all zeros when it is created, as optax's
``init`` makes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# optax.adafactor's defaults
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def _apply(p: torch.Tensor, update: torch.Tensor, lr) -> None:
    """``p + (-lr * u)``, optax's ``scale_by_learning_rate`` then
    ``apply_updates`` (``-(lr u)`` is exactly ``(-lr) u``)."""
    p.sub_(update * lr)


class Lion(torch.optim.Optimizer):
    """optax's lion; ``weight_decay`` per parameter group (0 where the
    decay mask leaves a leaf out)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.99),
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                update = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.copy_((1.0 - b2) * g + b2 * mu)
                if wd:
                    update = update + wd * p
                _apply(p, update, group["lr"])


def factored_dims(shape) -> "tuple[int, int] | None":
    """optax's ``_factored_dims``: the axes (second largest, largest) to
    reduce over when both are at least 128 long, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter that is this rank's block of a larger leaf: ``shape``
    is the whole leaf's, ``splits`` the ``(dim, mesh axis)`` pairs of the
    dims split over an axis of ``group`` (the rank's ``RankGroup``; a
    rank holds the contiguous block at its coordinate)."""

    shape: tuple
    splits: tuple
    group: Any

    def axis(self, dim: int):
        """The mesh axis that splits ``dim``, or None."""
        return dict(self.splits).get(dim)

    def without(self, dim: int) -> "Shard":
        """The shard of the leaf with ``dim`` reduced away."""
        return Shard(self.shape[:dim] + self.shape[dim + 1:],
                     tuple((d - (d > dim), a) for d, a in self.splits
                           if d != dim), self.group)

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The mean over the whole leaf's ``dim`` of this block ``x``:
        the block's sum, summed over the line along ``dim``'s axis."""
        total = x.sum(dim=dim)
        if self.axis(dim) is not None:
            total = _line_sum(total, self.group.along(self.axis(dim)))
        return total / self.shape[dim]

    def block_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x``'s elements over the whole leaf: every split
        line's sums added."""
        total = x.sum()
        axes = tuple(a for _, a in self.splits)
        if axes:
            total = _line_sum(total, self.group.over(axes))
        return total / float(np.prod(self.shape))


def _line_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, in rank order (a gather
    of the operands, summed on each rank alike)."""
    if group.world == 1:
        return x
    return group.all_gather(x.reshape((1,) + tuple(x.shape))).sum(0)


class Adafactor(torch.optim.Optimizer):
    """optax's adafactor at its defaults (see the module docstring);
    ``weight_decay`` per parameter group (0 = none, as optax's
    ``weight_decay_rate=None``). The state of a factored leaf is its row
    and column second moments, of any other leaf a full one, and every
    leaf keeps the step count (optax's one ``count``, kept per leaf so
    that a leaf's state is self-contained). ``shards`` maps a
    parameter's ``id`` to its :class:`Shard` where the parameter is one
    rank's block (its state then holds that block's moments: the slice
    of the whole leaf's, or all of it along a reduced dim); a step then
    sums over the shard's lines, a collective every rank of them
    makes."""

    def __init__(self, params, lr=1e-3, weight_decay: float = 0.0,
                 shards: "dict | None" = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.shards = dict(shards or {})

    def _shape(self, p: torch.Tensor) -> tuple:
        shard = self.shards.get(id(p))
        return tuple(p.shape) if shard is None else tuple(shard.shape)

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        state["step"] = torch.zeros((), dtype=torch.float32,
                                    device=p.device)
        dims = factored_dims(self._shape(p))
        if dims is None:
            state["v"] = torch.zeros_like(p)
            return
        d1, d0 = dims
        shape = list(p.shape)
        state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
        state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                shard = self.shards.get(id(p))
                if shard is not None:
                    self._sharded_step(p, g, state, group, shard)
                    continue
                t = state["step"]
                decay = 1.0 - (t + 1.0) ** (-ADAFACTOR_DECAY_RATE)
                grad_sqr = g * g + ADAFACTOR_EPS
                dims = factored_dims(tuple(p.shape))
                if dims is not None:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(decay * v_row
                                + (1.0 - decay) * grad_sqr.mean(dim=d0))
                    v_col.copy_(decay * v_col
                                + (1.0 - decay) * grad_sqr.mean(dim=d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                    row_factor = (v_row / row_col_mean) ** -0.5
                    col_factor = v_col ** -0.5
                    update = (g * row_factor.unsqueeze(d0)
                              * col_factor.unsqueeze(d1))
                else:
                    v = state["v"]
                    v.copy_(decay * v + (1.0 - decay) * grad_sqr)
                    update = g * v ** -0.5
                t.add_(1.0)
                # clip_by_block_rms(1.0)
                rms = torch.sqrt((update * update).mean())
                update = update / torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
                # scale_by_learning_rate (no sign flip yet)
                update = group["lr"] * update
                # scale_by_param_block_rms: numerics.safe_root_mean_squares
                p_rms = torch.sqrt((p * p).mean())
                update = update * torch.where(
                    p_rms <= ADAFACTOR_MIN_SCALE,
                    torch.full_like(p_rms, ADAFACTOR_MIN_SCALE), p_rms)
                if wd:
                    update = update + wd * p
                p.sub_(update)

    @staticmethod
    def _sharded_step(p: torch.Tensor, g: torch.Tensor, state: dict,
                      group: dict, shard: Shard) -> None:
        """:meth:`step` on one rank's block of a leaf, every mean and
        RMS the whole leaf's (see :class:`Shard`)."""
        t = state["step"]
        decay = 1.0 - (t + 1.0) ** (-ADAFACTOR_DECAY_RATE)
        grad_sqr = g * g + ADAFACTOR_EPS
        dims = factored_dims(tuple(shard.shape))
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.copy_(decay * v_row + (1.0 - decay)
                        * shard.mean(grad_sqr, d0))
            v_col.copy_(decay * v_col + (1.0 - decay)
                        * shard.mean(grad_sqr, d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = shard.without(d0).mean(
                v_row, reduced_d1).unsqueeze(reduced_d1)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            update = (g * row_factor.unsqueeze(d0)
                      * col_factor.unsqueeze(d1))
        else:
            v = state["v"]
            v.copy_(decay * v + (1.0 - decay) * grad_sqr)
            update = g * v ** -0.5
        t.add_(1.0)
        rms = torch.sqrt(shard.block_mean(update * update))
        update = update / torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
        update = group["lr"] * update
        p_rms = torch.sqrt(shard.block_mean(p * p))
        update = update * torch.where(
            p_rms <= ADAFACTOR_MIN_SCALE,
            torch.full_like(p_rms, ADAFACTOR_MIN_SCALE), p_rms)
        if group["weight_decay"]:
            update = update + group["weight_decay"] * p
        p.sub_(update)


class SGD(torch.optim.Optimizer):
    """optax's sgd: ``momentum`` 0 is plain gradient descent, > 0 the
    nesterov trace."""

    def __init__(self, params, lr=1e-3, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if not m:
                    _apply(p, g, group["lr"])
                    continue
                state = self.state[p]
                if not state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.copy_(g + m * trace)
                _apply(p, g + m * trace, group["lr"])
