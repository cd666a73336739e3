"""The CPU-checkable parts of chip_smoke.py, the port's on-card check.

The script needs a card to run; these pin what it computes around the
card: the device-time accounting of a profiler window (only rows that
ran on the card count: a CPU op's row repeats its kernels' time), the
flash kernels' bounds, and its refusal to run without CUDA.
"""

import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _row(key, device_type, ms, annotation=False):
    return types.SimpleNamespace(key=key, device_type=device_type,
                                 self_device_time_total=ms * 1e3,
                                 is_user_annotation=annotation)


def test_device_time_counts_each_kernel_once():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    averages = [_row("aten::mm", cpu, 6.0), _row("sgemm_kernel", cuda, 6.0),
                _row("FlashAttentionBackward", cpu, 8.0),
                _row("flash_dq_kernel", cuda, 3.0),
                _row("flash_dkv_kernel", cuda, 5.0),
                _row("Optimizer.step#AdamW.step", cuda, 2.0, True),
                _row("aten::empty", cpu, 0.0)]
    rows = chip_smoke.device_kernel_rows(torch, averages, n_steps=2)
    assert rows == [("sgemm_kernel", 3.0), ("flash_dq_kernel", 1.5),
                    ("flash_dkv_kernel", 2.5)]
    # not 15: no CPU op's row and no annotated range counted
    assert sum(ms for _, ms in rows) == 7.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bounds_count_live_pairs(dtype):
    """Operations: 4, 6, 8 flops per head_dim element of each live causal
    pair (fwd, dq, dk/dv) at the dtype's peak; bytes: each tensor read or
    written once (q-sized: q, o / dO, dq; k-sized: k, v / dk, dv; f32
    rows: lse, delta) at the memory rate; the bound is the larger."""
    b, t, h, h_kv, d = 2, 64, 4, 2, 32
    q = torch.zeros((b, t, h, d), dtype=dtype)
    k = torch.zeros((b, t, h_kv, d), dtype=dtype)
    pairs = b * h * t * (t + 1) // 2
    peak = chip_smoke.PEAK_FLOPS[str(dtype).split(".")[-1]]
    es = q.element_size()
    qb, kb, rows = q.numel() * es, k.numel() * es, 4 * b * h * t
    bounds = chip_smoke.flash_bounds(torch, q, k, True, None, 0, 0)
    for name, per_pair, nbytes in (
            ("flash_fwd", 4, 2 * qb + 2 * kb + rows),
            ("flash_dq", 6, 3 * qb + 2 * kb + 2 * rows),
            ("flash_dkv", 8, 2 * qb + 4 * kb + 2 * rows)):
        t_ops = per_pair * d * pairs / peak * 1e3
        t_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
        want = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
        assert bounds[name] == pytest.approx(want)
    # a window leaves fewer live pairs
    window = chip_smoke.flash_bounds(torch, q, k, True, 8, 0, 0)
    assert window["flash_dkv"][0] <= bounds["flash_dkv"][0]


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr
