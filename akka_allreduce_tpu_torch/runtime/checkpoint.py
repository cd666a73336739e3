"""Checkpoint / resume of training state, on torch state dicts.

Counterpart of ``akka_allreduce_tpu/runtime/checkpoint.py``. A checkpoint
is one directory per step, ``<directory>/<step>/``, holding
``params.pt`` (the nested params dict), ``opt_state.pt`` (the
optimizer's ``state_dict()``), with ``ema_decay`` ``ema.pt`` (the EMA
weights, params-shaped: the JAX package's ``ema`` item, which ``generate
--use-ema`` and ``eval --use-ema`` read) and ``extra.json`` (free-form
JSON: data position, counters). It is written into a temporary directory
beside it and renamed into place, so a crash mid-save never leaves a
torn checkpoint; the newest ``keep`` are retained. Saves are
synchronous, so ``wait_until_finished`` has nothing to wait for.

A data-parallel run passes its group (``parallel/group.py``): rank 0
writes params, optimizer state and extra, every rank writes its own ef8
error-feedback residual as ``sync-<rank>.pt`` (the JAX package's ``sync``
item, one plane per rank), and barriers hold the rename of the step
directory until every rank has written, and every rank until it is
renamed. :meth:`CheckpointManager.restore_sync` gives a rank its residual
back bitwise (an MoE run's file holds both planes, ``{"dense",
"expert"}``).

A run with tensor, expert or pipeline parallelism (tp, ep or pp > 1)
saves params, EMA and optimizer state in the full, unsharded list
layout, as the JAX package's checkpoint of its global arrays holds them
at pp = 1: its ranks gather them first (``models/train.py
full_layout``: a pp stage's stacked layers, and their moments, gathered
over ``pp`` and unstacked) and slice (and stack) them again on restore
(``convert.shard_params``, ``train.shard_optimizer_state``), so a ``--tp
2`` or ``--pp 2`` checkpoint restores at one rank into ``generate``,
``eval`` and ``serve``, and at any other mesh into ``train``.

The JAX package's orbax checkpoints are not read here (nor these by it):
the formats differ. ``scripts/orbax_to_torch.py``, run where JAX is
installed, converts a JAX checkpoint step into this format
(``convert.py train_state_from_jax``), which :meth:`CheckpointManager.
restore` and ``models/train.py load_optimizer_state`` then read as they
read the port's own. The JSON sidecars (``save_state_json`` /
``load_state_json`` / ``delete_state_json``) are the JAX package's: one
atomic file per name, so a serve drain persisted by either package is
restored by the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import torch

from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves

_ITEMS = ("params", "opt_state", "ema")


def _atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` to ``path`` through a temporary file, fsync and
    rename: a crash mid-write leaves the previous complete file."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def save_state_json(directory: str, name: str, payload: dict) -> str:
    """Atomically write ``payload`` as ``<directory>/<name>.json``;
    returns the path."""
    os.makedirs(directory, exist_ok=True)
    return _atomic_write_text(os.path.join(directory, f"{name}.json"),
                              json.dumps(payload))


def load_state_json(directory: str, name: str) -> Optional[dict]:
    """Read a :func:`save_state_json` file; None when absent."""
    try:
        with open(os.path.join(directory, f"{name}.json")) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def delete_state_json(directory: str, name: str) -> bool:
    """Remove a :func:`save_state_json` file (a consumed drain must not be
    restored twice); returns whether a file existed."""
    try:
        os.remove(os.path.join(directory, f"{name}.json"))
        return True
    except FileNotFoundError:
        return False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """``keep`` bounds the retained checkpoints; ``save_interval_steps``
    is the :meth:`CheckpointManager.maybe_save` cadence."""

    directory: str
    keep: int = 3
    save_interval_steps: int = 100


def _like(template: Any, loaded: Any) -> Any:
    """``loaded`` with the template's nesting, each tensor on the
    template tensor's device and dtype; a shape mismatch raises."""
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"restored keys {sorted(loaded)} != template "
                             f"{sorted(template)}")
        return {k: _like(template[k], loaded[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(template) != len(loaded):
            raise ValueError(f"restored list of {len(loaded)} != template "
                             f"{len(template)}")
        return [_like(t, x) for t, x in zip(template, loaded)]
    if tuple(template.shape) != tuple(loaded.shape):
        raise ValueError(f"restored leaf shape {tuple(loaded.shape)} != "
                         f"template {tuple(template.shape)}")
    return loaded.to(template.device, template.dtype)


class CheckpointManager:
    """Save/restore (params, opt_state, extra) keyed by step."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        os.makedirs(config.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.config.directory, str(step))

    def steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.config.directory)
                      if n.isdigit())

    # -- save --------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[dict] = None, force: bool = False,
             sync: Optional[torch.Tensor] = None, group=None,
             ema: Any = None) -> bool:
        """Save unconditionally (``force``) or per the interval policy
        (``step % save_interval_steps == 0``). Returns whether a save
        happened (as orbax's policy, never at or before the latest saved
        step unless forced). ``sync`` is this rank's ef8 residual;
        ``group`` makes the save collective: every rank of it calls
        ``save`` with the same step and takes the same decision (it
        reads the directory before any rank renames into it). ``ema``,
        when given, is saved as the ``ema`` item."""
        if not force and not self.due(step):
            return False
        rank = 0 if group is None else group.rank
        final = self._path(step)
        tmp = f"{final}.tmp" if group is not None \
            else f"{final}.tmp-{os.getpid()}"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if group is not None:
            group.barrier()  # the directory exists for every rank
        if rank == 0:
            for name, tree in (("params", params), ("opt_state", opt_state),
                               ("ema", ema)):
                if tree is not None:
                    torch.save(tree, os.path.join(tmp, f"{name}.pt"))
            _atomic_write_text(os.path.join(tmp, "extra.json"),
                               json.dumps(extra or {}))
        if sync is not None:
            torch.save(sync, os.path.join(tmp, f"sync-{rank}.pt"))
        if group is not None:
            group.barrier()  # every rank has written its part
        if rank == 0:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.steps()[:-self.config.keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        if group is not None:
            group.barrier()  # no rank reads before the rename
        return True

    def due(self, step: int) -> bool:
        """Whether the interval policy saves at ``step``: a multiple of
        ``save_interval_steps`` past the latest saved step (orbax's
        policy). Ranks that must gather their state before a save ask
        this first, every rank alike."""
        latest = self.latest_step()
        return not (step % max(1, self.config.save_interval_steps) or (
            latest is not None and latest >= step))

    def maybe_save(self, step: int, params: Any, opt_state: Any,
                   extra: Optional[dict] = None,
                   sync: Optional[torch.Tensor] = None, group=None,
                   ema: Any = None) -> bool:
        """Interval-gated save — safe to call every step."""
        return self.save(step, params, opt_state, extra, force=False,
                         sync=sync, group=group, ema=ema)

    # -- restore -----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve_step(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.isdir(self._path(step)):
            raise FileNotFoundError(
                f"no checkpoint under {self.config.directory}"
                + ("" if step is None else f" at step {step}"))
        return step

    def _load(self, step: int, name: str, device) -> Any:
        return torch.load(os.path.join(self._path(step), f"{name}.pt"),
                          map_location=device, weights_only=True)

    def _extra(self, step: int) -> dict:
        with open(os.path.join(self._path(step), "extra.json")) as f:
            return json.load(f)

    def items(self, step: Optional[int] = None) -> list:
        """The items the checkpoint at ``step`` (latest by default)
        holds."""
        step = self._resolve_step(step)
        return [name for name in _ITEMS if os.path.exists(
            os.path.join(self._path(step), f"{name}.pt"))]

    def _check_item(self, step: int, item: str) -> None:
        names = self.items(step)
        if item not in names:
            raise KeyError(f"item {item!r} not in checkpoint step {step}; "
                           f"available items: {sorted(names)}")

    def restore(self, params_like: Any, opt_state_like: Any,
                step: Optional[int] = None, ema: Any = None
                ) -> tuple[int, Any, Any, dict]:
        """``(step, params, opt_state, extra)``: params take the nesting,
        devices and dtypes of ``params_like`` (shapes must match);
        ``opt_state`` is the saved ``state_dict()``, its tensors on the
        params' device, for ``optimizer.load_state_dict``. ``ema``, when
        given, is the live EMA tree: the checkpoint's ``ema`` item is
        copied into it in place, bitwise (a checkpoint without one raises
        the ``KeyError`` that lists its items, as the JAX package's
        restore fails on a chain with an EMA slot that the checkpoint
        lacks)."""
        step = self._resolve_step(step)
        if ema is not None:
            self._check_item(step, "ema")
            saved = _like(ema, self._load(step, "ema", _first_device(ema)))
            with torch.no_grad():
                for live, value in zip(tree_leaves(ema), tree_leaves(saved)):
                    live.copy_(value)
        device = _first_device(params_like)
        params = _like(params_like, self._load(step, "params", device))
        opt_state = self._load(step, "opt_state", device)
        if isinstance(opt_state_like, dict) and \
                len(opt_state.get("param_groups", [])) != \
                len(opt_state_like.get("param_groups", [])):
            raise ValueError("restored optimizer state has another "
                             "parameter-group layout than the template")
        return step, params, opt_state, self._extra(step)

    def restore_params(self, params_like: Any, step: Optional[int] = None,
                       item: str = "params") -> tuple[int, Any, dict]:
        """Restore one item without the optimizer state (the weights-only
        consumer path; ``item="ema"`` the EMA weights of an ``ema_decay``
        run). An item the checkpoint lacks raises ``KeyError`` listing
        the items it holds."""
        step = self._resolve_step(step)
        self._check_item(step, item)
        loaded = self._load(step, item, _first_device(params_like))
        return step, _like(params_like, loaded), self._extra(step)

    def restore_sync(self, like: torch.Tensor, step: Optional[int] = None,
                     rank: int = 0) -> Optional[torch.Tensor]:
        """This rank's saved ef8 residual at ``step`` (latest by default)
        on ``like``'s device, bitwise (an MoE run's ``{"dense",
        "expert"}`` planes both); None when the checkpoint has none (a
        resume then restarts the error accumulator at zero)."""
        step = self._resolve_step(step)
        path = os.path.join(self._path(step), f"sync-{rank}.pt")
        if not os.path.exists(path):
            return None
        return _like(like, torch.load(path, map_location=_first_device(like),
                                      weights_only=True))

    # -- lifecycle ---------------------------------------------------------

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        """Nothing to release (no background writer)."""


def _first_device(tree: Any) -> torch.device:
    if isinstance(tree, dict):
        return _first_device(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_device(tree[0])
    return tree.device


def restore_or_init(config: CheckpointConfig, params: Any, opt_state: Any,
                    ema: Any = None
                    ) -> tuple[int, Any, Any, dict, CheckpointManager]:
    """Open the manager and either restore the latest checkpoint or keep
    the given state. Returns (next_step, params, opt_state, extra,
    manager); a given live ``ema`` tree takes the checkpoint's EMA in
    place (:meth:`CheckpointManager.restore`)."""
    mgr = CheckpointManager(config)
    step = mgr.latest_step()
    if step is None:
        return 0, params, opt_state, {}, mgr
    step, params, opt_state, extra = mgr.restore(params, opt_state, step,
                                                 ema=ema)
    return step + 1, params, opt_state, extra, mgr
