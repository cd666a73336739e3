"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asking
for CUDA on a machine without it raises: a run never carries on silently
on the CPU, where every kernel would be replaced by its plain version.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> a torch.device."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu (device='cpu') to run on the CPU")
    return dev
