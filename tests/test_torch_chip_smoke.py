"""The CPU-checkable parts of chip_smoke.py, the port's on-card check.

The script needs a card to run; these pin what it computes around the
card: the device-time accounting of a profiler window (only rows that
ran on the card count: a CPU op's row repeats its kernels' time), the
flash and ring kernels' bounds, the kernels line's flash rows, the build
phase's check of the tensor-core kernels, phase 16's straggle schedule
and expected launches, phase 10's and 17's rehearsals at a tiny size
with the hierarchical launch arithmetic, and its refusal to run without
CUDA.
"""

import json
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
from akka_allreduce_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS)


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


@pytest.mark.parametrize("q_off,k_off,live", [(64, 64, 64 * 65 // 2),
                                              (64, 0, 64 * 64)])
def test_ring_bounds_count_the_hop(q_off, k_off, live):
    """A hop's live pairs (the diagonal hop's triangle, a past hop's
    square) at the flash kernels' 4, 6, 8 flops per head_dim element; its
    bytes add the f32 state read and written once: (m, l) and acc
    forward, dq or (dk, dv) backward."""
    b, t, h, h_kv, d = 2, 64, 4, 2, 32
    q = torch.zeros((b, t, h, d), dtype=torch.bfloat16)
    k = torch.zeros((b, t, h_kv, d), dtype=torch.bfloat16)
    pairs = b * h * live
    qb, kb, rows = q.numel() * 2, k.numel() * 2, 4 * b * h * t
    q32, k32 = 4 * q.numel(), 4 * k.numel()
    bounds = chip_smoke.ring_bounds(torch, q, k, True, q_off, k_off)
    for name, per_pair, nbytes in (
            ("ring_fwd", 4, qb + 2 * kb + 4 * rows + 2 * q32),
            ("ring_dq", 6, 2 * qb + 2 * kb + 2 * rows + 2 * q32),
            ("ring_dkv", 8, 2 * qb + 2 * kb + 2 * rows + 4 * k32)):
        t_ops = per_pair * d * pairs / chip_smoke.PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
        assert bounds[name][0] == pytest.approx(max(t_ops, t_bytes))
    # the kernels line reports the ring kernels of phase 11's past hop
    assert [s[0] for s in chip_smoke.RING_SHAPES[:2]] == [
        "slice-diagonal", "slice-past"]
    assert set(chip_smoke.RING_REPLACES) == {"ring_fwd", "ring_dq",
                                             "ring_dkv"}


def test_ring_bounds_at_the_split_tf32_rate():
    """The f32 forward, dq and dk/dv run three TF32 products a product:
    their bound at 495 / 3 TFLOP/s, beside the CUDA cores' 67, on the same
    live pairs and bytes (a past hop at phase 11's head dim,
    operations-bound)."""
    b, t, h, h_kv, d = 2, 256, 4, 2, 128
    q = torch.zeros((b, t, h, d))
    k = torch.zeros((b, t, h_kv, d))
    cuda_cores = chip_smoke.ring_bounds(torch, q, k, True, t, 0)
    split = chip_smoke.ring_bounds(torch, q, k, True, t, 0, "tf32x3")
    assert chip_smoke.PEAK_FLOPS["tf32x3"] == pytest.approx(495e12 / 3)
    for name, per_pair in (("ring_fwd", 4), ("ring_dq", 6),
                           ("ring_dkv", 8)):
        assert split[name] == (pytest.approx(
            per_pair * d * b * h * t * t / (495e12 / 3) * 1e3), "operations")
        assert cuda_cores[name][0] == pytest.approx(
            split[name][0] * (495e12 / 3) / 67e12)

def test_flash_bounds_at_the_split_tf32_rate():
    """The f32 flash forward, dq and dk/dv run three TF32 products a
    product: their bound at 495 / 3 TFLOP/s on the same live pairs, beside
    the CUDA cores' 67 (phase 5's causal shape at its head dim,
    operations-bound)."""
    b, t, h, d = 2, 1024, 4, 128
    q = torch.zeros((b, t, h, d))
    cuda_cores = chip_smoke.flash_bounds(torch, q, q, True, None, 0, 0)
    split = chip_smoke.flash_bounds(torch, q, q, True, None, 0, 0, "tf32x3")
    for name, per_pair in (("flash_fwd", 4), ("flash_dq", 6),
                           ("flash_dkv", 8)):
        assert split[name] == (pytest.approx(
            per_pair * d * b * h * t * (t + 1) // 2 / (495e12 / 3) * 1e3),
            "operations")
        assert cuda_cores[name][0] == pytest.approx(
            split[name][0] * (495e12 / 3) / 67e12)


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}
# the flash and ring rows also name their CUDA kernel
FLASH_ROW_KEYS = KERNEL_KEYS | {"kernel"}


@pytest.mark.parametrize("suffix", ["", "_f32"])
def test_flash_kernel_rows_carry_every_key(suffix):
    """The kernels line's flash rows: every key of the line and the CUDA
    kernel's name, the launches given, the worst error of each kernel's
    outputs; in f32 every bound is the split-TF32 one that phase 5
    computed."""
    frow = {"max_abs_err": {"o": 1e-6, "lse": 2e-6, "dq": 3e-6, "dk": 5e-6,
                            "dv": 4e-6},
            "ms": {"flash_fwd": 7.0, "flash_dq": 4.0, "flash_dkv": 5.0},
            "plain_ms": {"forward": 17.0, "backward": 28.0},
            "library_ms": {"forward": 3.2, "backward": 10.4},
            "bound_ms": {"flash_fwd": 2.05, "flash_dq": 3.08,
                         "flash_dkv": 4.1},
            "bound_by": dict.fromkeys(("flash_fwd", "flash_dq",
                                       "flash_dkv"), "operations")}
    if suffix:
        frow["bound_tf32x3_ms"] = {"flash_fwd": 0.83, "flash_dq": 1.25,
                                   "flash_dkv": 1.67}
    launches = {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32}
    rows = chip_smoke.flash_kernel_rows(frow, launches, suffix)
    assert [r["name"] for r in rows] == [
        f"flash_fwd{suffix}", f"flash_dq{suffix}", f"flash_dkv{suffix}"]
    assert all(set(r) == FLASH_ROW_KEYS and r["launches"] == 32
               for r in rows)
    assert [r["kernel"] for r in rows] == [
        f"flash_fwd{'_tf32' if suffix else ''}_mma_kernel",
        f"flash_dq{'_tf32' if suffix else ''}_mma_kernel",
        f"flash_dkv{'_tf32' if suffix else ''}_mma_kernel"]
    assert [r["max_abs_err"] for r in rows] == [2e-6, 3e-6, 5e-6]
    assert [r["bound_ms"] for r in rows] == (
        [0.83, 1.25, 1.67] if suffix else [2.05, 3.08, 4.1])
    assert [r["replaces"].rsplit(":", 1)[1] for r in rows] == [
        "113", "153", "184"]


def test_long_positions_fill_the_tables_second_half():
    """The ``"long"`` mode puts every lane in [n_pt * P / 2, n_pt * P):
    4,096-8,191 at the long shape (n_pt 512, P 16)."""
    shape = (8, 4, 2, 16, 4, 32)
    _, _, _, _, pos = chip_smoke.make_case(torch, shape, torch.float32, 0,
                                           "long", device="cpu")
    assert pos.dtype == torch.int32 and pos.shape == (8,)
    assert int(pos.min()) >= 64 and int(pos.max()) <= 127
    _, _, _, _, p, n_pt = chip_smoke.LONG_SHAPE
    assert chip_smoke.LONG_SHAPE in chip_smoke.KERNEL_SHAPES
    assert (n_pt * p // 2, n_pt * p) == (4096, 8192)


@pytest.mark.parametrize("shape", [(8, 4, 2, 16, 4, 32),
                                   (8, 4, 1, 16, 8, 4),
                                   (8, 16, 16, 16, 4, 32)])
def test_edge_positions_cross_a_split_boundary(shape):
    """Lanes 4 and 5 of ``"edges"``: the live pages an exact multiple of
    the kernel's S (or the table less one page), then one page more,
    which gives every split one page more to take (and leaves the last
    empty where S exceeds the old share by 2); the last lane is parked on
    page 0 at pos 0."""
    _, _, _, _, p, n_pt = shape
    _, _, _, table, pos = chip_smoke.make_case(torch, shape, torch.float32,
                                               1, "edges", device="cpu")
    splits = chip_smoke.case_splits(torch, shape, device="cpu")
    n_live = (pos.long() // p + 1).tolist()
    assert pos[:4].tolist() == [0, p - 1, p, n_pt * p - 1]
    assert n_live[4] % splits == 0 or n_live[4] == n_pt - 1
    assert n_live[5] == n_live[4] + 1 <= n_pt
    share = -(-n_live[4] // splits)
    if n_live[4] % splits == 0:
        assert -(-n_live[5] // splits) == share + 1
        if splits >= share + 2:  # the last split is empty
            assert n_live[5] <= (splits - 1) * (share + 1)
    assert pos[-1] == 0 and int(table[-1].abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_bound_at_the_long_shape(dtype):
    """Bytes: each live K/V row read once (2 x live x h_kv x D), q read
    and out written, a table entry a live page and pos: ~200 MB of f32 K/V
    at 3.35 TB/s, about 0.06 ms; bf16 half that."""
    b, h, h_kv, d, p, n_pt = chip_smoke.LONG_SHAPE
    q = torch.zeros((b, 1, h, d), dtype=dtype)
    k_pages = torch.zeros(1, dtype=dtype).expand(b * n_pt + 1, p, h_kv, d)
    pos = torch.arange(4096, 8192, 512, dtype=torch.int32)
    bound, by = chip_smoke.paged_bound(torch, q, k_pages, None, pos)
    es = q.element_size()
    live = int((pos.long() + 1).sum())
    pages = int((pos.long() // p + 1).sum())
    nbytes = 2 * live * h_kv * d * es + 2 * q.numel() * es + 4 * (pages + b)
    assert by == "bytes"
    assert bound == pytest.approx(nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    assert 0.055 * es / 4 < bound < 0.065 * es / 4


def test_split_shapes_cover_the_rule_below_its_cap():
    """Phase 3's S timings reach shapes where the wrapper's S is not the
    cap of 8 (MHA: 3; 64 lanes: 2; 128 lanes: 1) beside the serve shape
    and the long cache (8), and each time the cap itself."""
    picks = [chip_smoke.case_splits(torch, shape, device="cpu")
             for shape in chip_smoke.SPLIT_SHAPES]
    assert picks == [8, 3, 2, 1, 8]
    assert max(chip_smoke.SPLIT_COUNTS) == 8
    assert chip_smoke.KERNEL_SHAPES[0] in chip_smoke.SPLIT_SHAPES
    assert chip_smoke.LONG_SHAPE in chip_smoke.SPLIT_SHAPES


def _long_rows(dtype):
    """Rows shaped as a long cache's outputs: 2 lanes x 4 heads x 128,
    values ~0.02 (the softmax average of thousands of randn rows)."""
    gen = torch.Generator().manual_seed(0)
    return (0.02 * torch.randn((2, 1, 4, 128), generator=gen)).to(dtype)


def test_paged_agrees_holds_bf16_to_each_rows_scale():
    """bf16: one bf16 step on every element passes; a shift of 5e-3 in
    one head's row (a quarter of a typical value there, well under the
    fixed 2e-2) fails; rows of ~1 keep 2e-2 as their limit."""
    want = _long_rows(torch.bfloat16)
    step = torch.nextafter(want.float(), torch.tensor(1.0)).to(
        torch.bfloat16)
    ok, share = chip_smoke.paged_agrees(torch, step, want)
    assert ok and share <= 0.5
    shifted = want.float()
    shifted[1, 0, 2] += 5e-3
    ok, share = chip_smoke.paged_agrees(torch, shifted.to(torch.bfloat16),
                                        want)
    assert not ok and share > 1.0
    big = torch.full((1, 1, 1, 128), 3.0, dtype=torch.bfloat16)
    ok, share = chip_smoke.paged_agrees(torch, big + 0.015625, big)
    assert ok and share == pytest.approx(0.015625 / 2e-2)


def test_paged_agrees_f32_and_non_finite():
    """f32: atol = rtol = 1e-5; a NaN or inf output never agrees."""
    want = _long_rows(torch.float32)
    assert chip_smoke.paged_agrees(torch, want + 9e-6, want)[0]
    assert not chip_smoke.paged_agrees(torch, want + 2e-5, want)[0]
    bad = want.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert not chip_smoke.paged_agrees(torch, bad, want)[0]
    bad[0, 0, 0, 0] = float("inf")
    assert not chip_smoke.paged_agrees(torch, bad, want)[0]


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


class _LoopbackGroup:
    """A stand-in for a RankGroup of ``world`` ranks, a ``(world / sp,
    sp)`` mesh, inside one process: every peer sends what this rank
    sends. The sums it gives are wrong, but the control flow (which
    kernels each schedule calls, how often) is the real one."""

    def __init__(self, world, sp=1):
        self.rank, self.world, self.sp = 0, world, sp
        self.backend = "loopback"
        self.device = torch.device("cpu")

    def axis_size(self, axis):
        return self.sp if axis == "sp" else self.world // self.sp

    def axis_index(self, axis):
        return 0

    def along(self, axis):
        return _LoopbackGroup(self.axis_size(axis))

    def all_to_all(self, x):
        return x.clone()

    def all_gather(self, x):
        return torch.cat([x] * self.world)

    def exchange(self, x, peer):
        return x.clone()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("schedule", ["fused", "windowed", "swing"])
@pytest.mark.parametrize("transport", ["f32", "bf16", "int8", "ef8"])
@pytest.mark.parametrize("num_buckets", [9, 1])
def test_sync_launch_arithmetic(monkeypatch, world, schedule, transport,
                                num_buckets):
    """Phase 9's expected launches per sync equal the kernel wrappers
    that ``allreduce_gradients`` calls, counted on the CPU."""
    from akka_allreduce_tpu_torch.ops import collectives
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    calls = dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)

    def counting(name):
        fn = getattr(collectives, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    # the sync reaches no bits-tensor per-row quantizer (row 2)
    assert not hasattr(collectives, "quantize_int8")
    for name in chip_smoke.MAIN_PATH_SYNC:
        monkeypatch.setattr(collectives, name, counting(name))
    cfg = GradSyncConfig(bucket_elems=256, transport=transport,
                         transport_schedule=schedule, num_windows=4)
    grads = {"w": torch.randn(num_buckets * 256 - 7)}
    allreduce_gradients(grads, cfg, _LoopbackGroup(world), quant_key=(1,))
    assert calls == chip_smoke.expected_sync_launches(
        transport, schedule, world, num_buckets, 4)


@pytest.mark.parametrize("num_buckets", [9, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_hierarchical_launch_arithmetic(monkeypatch, num_buckets, masked):
    """Phase 17's expected launches of one hierarchical sync on a (dp 2,
    sp 2) mesh: the wrappers ``allreduce_gradients`` calls, counted on
    the CPU, masked or not."""
    from akka_allreduce_tpu_torch.ops import collectives
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    calls = dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)

    def counting(name):
        fn = getattr(collectives, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in chip_smoke.MAIN_PATH_SYNC:
        monkeypatch.setattr(collectives, name, counting(name))
    cfg = GradSyncConfig(bucket_elems=256, transport="ef8",
                         transport_schedule="hierarchical")
    res = allreduce_gradients(
        {"w": torch.randn(num_buckets * 256 - 7)}, cfg,
        _LoopbackGroup(4, sp=2), quant_key=(1,),
        valid=torch.arange(num_buckets) % 2 if masked else None)
    assert res.schedule == "hierarchical"
    assert calls == chip_smoke.expected_sync_launches(
        "ef8", "hierarchical", 4, num_buckets) == {
        **dict.fromkeys(chip_smoke.SYNC_KERNELS, 0), "masked_reduce": 1,
        "quantize_int8_block_rtn": 1, "quantize_int8_block": 1,
        "dequantize_int8_block": 3}


def test_phase10_rehearsal_with_the_hierarchical_cases(monkeypatch):
    """Phase 10 at a tiny bucket matrix on four CPU ranks, (dp 2, sp 2):
    every case passes, the two hierarchical ones (masked and not) among
    them."""
    assert [c for c in chip_smoke.SYNC4_CASES
            if c["schedule"] == "hierarchical"] == [
        {"transport": "ef8", "schedule": "hierarchical", "masked": m}
        for m in (False, True)] and chip_smoke.SYNC4_SP == 2
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SYNC4_SHAPE", (10, 1024))
    assert chip_smoke.phase_sync4(torch) == {
        "cases": len(chip_smoke.SYNC4_CASES)}


TINY_TRAIN = ["train", "--d-model", "64", "--n-heads", "2", "--n-layers",
              "1", "--d-ff", "128", "--vocab", "97", "--seq", "32",
              "--batch", "4", "--steps", "3", "--log-every", "1",
              "--bucket-elems", "1024", "--device", "cpu"]


@pytest.fixture
def phase17_on_cpu(monkeypatch):
    """Phase 17 at a tiny size on the CPU: the plain versions launch no
    kernel, so the expected launches are zeroed; the loss bound is this
    size's own (the sound run's gap read 4.3e-4, the dropped-line
    control's 2.0e-3, the no-update control's 1.6e-2)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "HIER_ARGV", TINY_TRAIN)
    # the ipc transport needs the card: the CPU ranks ride gloo, and the
    # ipc run's twin is then a second gloo run
    on_cpu = {"cuda": "cpu", "ipc": "gloo"}
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "HIER_DIST", [
        on_cpu.get(a, a) for a in chip_smoke.HIER_DIST])
    monkeypatch.setattr(chip_smoke, "AUTO_ARGV", [
        on_cpu.get(a, a) for a in chip_smoke.AUTO_ARGV])
    monkeypatch.setattr(chip_smoke, "BENCH_BACKEND", "gloo")
    monkeypatch.setattr(chip_smoke, "BENCH_GOODPUT", (20_000, 4096))
    monkeypatch.setattr(chip_smoke, "BENCH_PAYLOADS", ((20_000, 4096),))
    monkeypatch.setattr(chip_smoke, "BENCH_SET_S", 0.05)
    monkeypatch.setattr(chip_smoke, "HIER_LOSS_ATOL", 1e-3)
    monkeypatch.setattr(chip_smoke, "expected_sync_launches",
                        lambda *a, **k: dict.fromkeys(
                            chip_smoke.SYNC_KERNELS, 0))
    monkeypatch.setattr(chip_smoke, "expected_attention_launches",
                        lambda *a, **k: {
                            "ring": dict.fromkeys(chip_smoke.RING_REPLACES, 0),
                            "flash": dict.fromkeys(chip_smoke.FLASH_REPLACES,
                                                   0)})


def test_phase17_full_width_run_rehearsal(phase17_on_cpu):
    out = chip_smoke.phase_hierarchical(torch)
    row = out["row"]
    assert row["num_buckets"] == -(-row["params"] // 1024)
    assert len(set(row["param_checksums"])) == 1
    assert row["loss_rel_diff"][0] <= chip_smoke.SP_LOSS_RTOL
    assert chip_smoke.HIER_DIST[-1] == "hierarchical"


def test_phase17_auto_plans_rehearsal(phase17_on_cpu, tmp_path):
    hashes = chip_smoke.phase_auto(torch, str(tmp_path))["hashes"]
    assert hashes[0] == hashes[1] != hashes[2]


def test_phase17_bench_rows_rehearsal(phase17_on_cpu, capfd):
    assert chip_smoke.phase_bench_rows(torch) == {"rows": 1 + 5 + 4}
    rows = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith('{"phase": "bench_row"')]
    assert len(rows) == 10
    assert '"metric": "allreduce_goodput_0.02M_f32_4cpu"' in rows[0]
    for row in map(json.loads, rows):
        # every row says what resolved it: the rounds of its sets (sized
        # up from 4 / 1 to BENCH_SET_S) and the spread its reps allow
        assert row["spread"] >= 0
        if row["unit"] == "GB/s":
            lo, hi = row["rounds"]
            assert hi >= chip_smoke.BENCH_R_HI and lo == max(1, hi // 4)


def test_phase17_hops_are_held_in_phase11():
    """Phase 17's layout (MHA, batch 8 over dp 2, seq 2048 over sp 2)
    gives rank (i, 1) a diagonal hop and a past hop: both are phase 11
    shapes, so its ring kernels run at a shape held against the plain
    versions."""
    from akka_allreduce_tpu_torch import cli
    a = cli.build_parser().parse_args(chip_smoke.HIER_ARGV
                                      + chip_smoke.HIER_DIST)
    b, t = a.batch // a.dp, a.seq // a.sp
    h_kv = a.kv_heads or a.n_heads
    d = a.d_model // a.n_heads
    shapes = {s[1:] for s in chip_smoke.RING_SHAPES}
    assert (b, t, a.n_heads, h_kv, d, True, t, t) in shapes
    assert (b, t, a.n_heads, h_kv, d, True, t, 0) in shapes


@pytest.mark.parametrize("sp, rank, ring, flash", [
    (1, 0, 0, 12), (2, 0, 12, 0), (2, 1, 24, 0), (2, 2, 12, 0),
    (2, 3, 24, 0)])
def test_expected_attention_launches(sp, rank, ring, flash):
    """4 layers, 3 steps: one card runs each flash kernel 12 times; rank
    (i, j) of sp 2 each ring kernel 4 (j + 1) x 3 times."""
    got = chip_smoke.expected_attention_launches(4, sp, rank, 3)
    assert got == {"ring": dict.fromkeys(chip_smoke.RING_REPLACES, ring),
                   "flash": dict.fromkeys(chip_smoke.FLASH_REPLACES, flash)}


def test_line_drop_at_phase17_batches():
    """Phase 17's step-1 draws (8 x 2048 of vocab 32768, four data
    ranks) are 0.3608, 0.7203 | 0.4197, 0.3791: the midpoint of the lines'
    least draws, 0.3699, makes rank 0 late alone, so its sp line (dp
    line 0) is masked and line 1 is not."""
    from akka_allreduce_tpu_torch import cli
    a = cli.build_parser().parse_args(chip_smoke.HIER_ARGV
                                      + chip_smoke.HIER_DIST)
    draws = chip_smoke.straggle_draws(1, 4, a.batch, a.seq, a.vocab)
    prob, line = chip_smoke.choose_line_drop(draws, a.sp)
    assert line == 0 and round(prob, 4) == 0.3699
    late = [d < prob for d in draws[0]]
    assert late == [True, False, False, False]
    with pytest.raises(ValueError, match="same least"):
        chip_smoke.choose_line_drop([[0.1, 0.5, 0.1, 0.7]], 2)


def test_phase9_flagship_launches_per_run():
    """The flagship's bucket matrix at dp=2, fused: 3 steps of one sync
    each (8,257 buckets of 65,536: ceil(541,100,032 / 65,536))."""
    buckets = -(-541_100_032 // chip_smoke.BUCKET_ELEMS)
    assert buckets == 8257
    per = {w: chip_smoke.expected_sync_launches(t, "fused", 2, buckets, 4)
           for w, t in (("none", "f32"), ("int8", "int8"), ("ef8", "ef8"))}
    nonzero = {w: {k: 3 * v for k, v in p.items() if v}
               for w, p in per.items()}
    assert nonzero == {
        "none": {"masked_reduce": 3},
        "int8": {"quantize_int8_prng": 6, "dequantize_int8": 3},
        "ef8": {"quantize_int8_block_rtn": 3, "quantize_int8_block": 3,
                "dequantize_int8_block": 9}}
    # the wires launch every sync kernel but row 2, the bits-tensor
    # per-row quantizer (held against its plain version in phase 8)
    assert set().union(*nonzero.values()) == set(chip_smoke.MAIN_PATH_SYNC)
    assert set(chip_smoke.SYNC_KERNELS) - set(chip_smoke.MAIN_PATH_SYNC) \
        == {"quantize_int8"}
    assert chip_smoke.DP_WIRES == ("none", "int8", "ef8")


def test_straggle_draws_are_the_train_commands():
    """Phase 16's reconstruction of ``train --deadline-ms``'s draws: the
    command's rounds at one rank (every late round falls back) equal
    ``predicted_rounds`` of ``straggle_draws`` at its batch shape."""
    from akka_allreduce_tpu_torch import cli
    prob = 0.5
    report = cli.run_train(cli.build_parser().parse_args(
        ["train", "--device", "cpu", "--steps", "4", "--batch", "2",
         "--seq", "16", "--vocab", "97", "--deadline-ms", "5",
         "--straggle-prob", str(prob)]))
    draws = chip_smoke.straggle_draws(4, 1, 2, 16, 97)
    got = [{k: r[k] for k in ("n_masked", "fell_back", "min_bucket_count")}
           for r in report["deadline"]["rounds"]]
    assert got == chip_smoke.predicted_rounds(draws, prob)
    assert {r["fell_back"] for r in got} == {True, False}


def test_deadline_schedule_at_the_flagship():
    """The flagship's batches (8 x 2048 of vocab 32768) at dp=2 give 4
    steps: clean, rank 0 masked, clean, both masked (the fallback)."""
    args = chip_smoke.DP_ARGV
    shape = [int(args[args.index(f) + 1])
             for f in ("--batch", "--seq", "--vocab")]
    draws = chip_smoke.straggle_draws(chip_smoke.DEADLINE_MAX_STEPS,
                                      chip_smoke.DP_WORLD, *shape)
    prob, steps = chip_smoke.choose_straggle(draws)
    assert steps == 4 and 0.3247 < prob <= 0.3608
    assert chip_smoke.predicted_rounds(draws[:steps], prob) == [
        {"n_masked": 0, "fell_back": False, "min_bucket_count": 2},
        {"n_masked": 1, "fell_back": False, "min_bucket_count": 1},
        {"n_masked": 0, "fell_back": False, "min_bucket_count": 2},
        {"n_masked": 2, "fell_back": True, "min_bucket_count": 2}]
    assert draws[1, 0] < prob <= draws[1, 1]  # step 2's late rank is 0


def test_choose_straggle_needs_a_clean_first_step():
    import numpy as np
    # step 1 has a draw below every both-late step's larger draw
    draws = np.array([[0.1, 0.9], [0.5, 0.9], [0.6, 0.7]])
    with pytest.raises(ValueError, match="clean step 1"):
        chip_smoke.choose_straggle(draws)
    prob, steps = chip_smoke.choose_straggle(
        np.array([[0.8, 0.9], [0.2, 0.9], [0.3, 0.4]]))
    assert steps == 3 and 0.4 < prob <= 0.8


@pytest.mark.parametrize("transport", ["f32", "bf16", "int8", "ef8"])
def test_a_masked_round_launches_what_an_exact_one_does(monkeypatch,
                                                         transport):
    """Phase 16 expects one exact sync's launches a step: the wrappers
    ``allreduce_gradients`` calls with a mask (the fallback's mask of
    ones, and one masking half the buckets) equal those without."""
    from akka_allreduce_tpu_torch.ops import collectives
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    calls = dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in chip_smoke.MAIN_PATH_SYNC:
        monkeypatch.setattr(collectives, name, counting(collectives, name))
    cfg = GradSyncConfig(bucket_elems=256, transport=transport)
    grads = {"w": torch.randn(9 * 256 - 7)}
    counts = []
    for valid in (None, torch.ones(9), torch.arange(9) % 2):
        calls.update(dict.fromkeys(calls, 0))
        allreduce_gradients(grads, cfg, _LoopbackGroup(2), valid=valid,
                            quant_key=(1,))
        counts.append(dict(calls))
    assert counts[0] == counts[1] == counts[2]
    sync, flash = chip_smoke.expected_deadline_launches(transport, 2, 9, 4,
                                                        8)
    assert sync == {k: 4 * v for k, v in counts[0].items()}
    assert flash == 32


@pytest.mark.parametrize("world", [2, 4])
def test_masked_reduce_main_path_shape(monkeypatch, world):
    """Phase 8 times the masked reduce at the staging matrix the f32
    sync gives it: ``main_path_staging`` equals the shape the kernel
    wrapper receives from ``allreduce_gradients``; at the flagship dp=2,
    2 x 270,565,376."""
    from akka_allreduce_tpu_torch.ops import collectives
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    shapes = []
    real = collectives.masked_reduce

    def recording(staged, *a, **k):
        shapes.append(tuple(staged.shape))
        return real(staged, *a, **k)
    monkeypatch.setattr(collectives, "masked_reduce", recording)
    n = 9 * 256 - 7
    allreduce_gradients({"w": torch.randn(n)},
                        GradSyncConfig(bucket_elems=256),
                        _LoopbackGroup(world))
    assert shapes == [chip_smoke.main_path_staging(n, world, 256)]
    assert chip_smoke.main_path_staging(541_100_032) == (2, 270_565_376)


@pytest.mark.parametrize("kernel,per_elem", [
    ("quantize_int8", 9), ("quantize_int8_prng", 5),
    ("quantize_int8_block", 9), ("quantize_int8_block_rtn", 5),
    ("dequantize_int8", 5), ("dequantize_int8_block", 5)])
def test_sync_kernel_bounds_count_bytes(kernel, per_elem):
    rows, cols, nb = 8257, 65536, 128
    t, by = chip_smoke.quant_bound(kernel, rows, cols, nb)
    want = (per_elem * rows * cols + 4 * rows * nb) \
        / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert by == "bytes" and t == pytest.approx(want)
    t, by = chip_smoke.reduce_bound(8, 3_276_800)
    assert by == "bytes" and t == pytest.approx(
        4 * (9 * 3_276_800 + 9) / chip_smoke.PEAK_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_allreduce_bounds_count_bytes(n):
    """Phase 14's bounds with all n ranks on one card: the function's
    own bytes (each rank's input read and output written once), the
    kernels' push / reduce / gather schedule (2N + 4(n-1)/n N a rank,
    both add orders: 4N at two ranks, 5N at four) and the parent's
    per-step schedules (the ring the same, the swing (1 + 4 log2 n) N a
    rank: 5N at two ranks, 9N at four)."""
    elems = 1 << 20
    p, rate = 4 * elems, chip_smoke.PEAK_BYTES_PER_S / 1e3
    bounds = chip_smoke.allreduce_bounds(n, elems)
    assert set(bounds) == set(chip_smoke.ALLREDUCE_REPLACES)
    schedule = n * (2 * p + 4 * (n - 1) / n * p) / rate
    swing_parent = n * (1 + 4 * (n.bit_length() - 1)) * p / rate
    for name, parent in (("ring_allreduce", schedule),
                         ("swing_allreduce", swing_parent)):
        assert bounds[name]["function"] == pytest.approx(2 * n * p / rate)
        assert bounds[name]["schedule"] == pytest.approx(schedule)
        assert bounds[name]["parent"] == pytest.approx(parent)
    if n == 2:  # 5N against the kernels' 4N
        assert bounds["swing_allreduce"]["parent"] == pytest.approx(
            1.25 * schedule)


def test_allreduce_runs_divide_into_lanes():
    """The flagship's bucket matrix flattened at two ranks, 64M at four:
    both split into n ring blocks of whole 128-lanes (and n is a power of
    two for the swing)."""
    (n2, full), (n4, part) = chip_smoke.ALLREDUCE_RUNS
    assert (n2, full, n4, part) == (2, 541_130_752, 4, 67_108_864)
    for n, elems in chip_smoke.ALLREDUCE_RUNS:
        assert elems % (n * 128) == 0 and n & (n - 1) == 0


def test_int_checksum_sees_every_bit():
    x = torch.randn(3 * 1000 + 1)
    y = x.clone()
    assert chip_smoke.int_checksum(torch, x) == chip_smoke.int_checksum(
        torch, y)
    y.view(torch.int32)[1234] ^= 1  # one low mantissa bit
    assert chip_smoke.int_checksum(torch, x) != chip_smoke.int_checksum(
        torch, y)
    z = x.clone()
    z[[5, 6]] = z[[6, 5]]  # the same bits, two places swapped
    assert chip_smoke.int_checksum(torch, x) != chip_smoke.int_checksum(
        torch, z)


@pytest.mark.parametrize("h, h_kv, head", [(4, 2, 0), (4, 2, 3), (4, 4, 1)])
def test_drop_query_head_loses_exactly_that_heads_share(h, h_kv, head):
    # phase 7's planted fault: dk/dv of the dropped head's KV head lose
    # that head's share, every other KV head is untouched
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, h, 16, generator=g)
    k, v = (torch.randn(2, 24, h_kv, 16, generator=g) for _ in range(2))
    do = torch.randn(2, 24, h, 16, generator=g)
    o, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(o, do)
    sound = fa.flash_dkv(q, k, v, do, lse, delta)
    faulty = chip_smoke.drop_query_head(fa.flash_dkv, head)(
        q, k, v, do, lse, delta)
    # the head's share alone: every other head's dO and delta zeroed
    keep = torch.zeros(h, dtype=torch.bool)
    keep[head] = True
    share = fa.flash_dkv(q, k, v, do * keep[:, None], lse,
                         delta * keep[:, None], True)
    hk = head // (h // h_kv)
    for s, f, d in zip(sound, faulty, share):
        torch.testing.assert_close(f + d, s, rtol=1e-5, atol=1e-5)
        assert d[:, :, hk].abs().max() > 0.1
        others = [i for i in range(h_kv) if i != hk]
        assert torch.equal(f[:, :, others], s[:, :, others])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step0_parity_control_fails_where_the_sound_path_passes(
        monkeypatch, dtype):
    # phase 7 on a tiny gqa model on the CPU (the wrappers' plain
    # versions): the sound flash path passes the gradient limit at every
    # seed, one lost query head's share fails it, and the wrapper is put
    # back afterwards
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    args = cli.build_parser().parse_args(
        ["train", "--d-model", "64", "--n-heads", "4", "--kv-heads", "2",
         "--rope", "--n-layers", "2", "--d-ff", "128", "--vocab", "128",
         "--seq", "32", "--batch", "2", "--device", "cpu"]
        + (["--bf16"] if dtype == "bfloat16" else []))
    cfg = {impl: cli.train_config(args, args.seq, impl)
           for impl in ("flash", "local")}
    tol = chip_smoke.PARITY_TOL[dtype]
    sound = fa.flash_dkv
    for seed in chip_smoke.PARITY_SEEDS:
        r = chip_smoke.step0_parity(torch, args, cfg, seed)
        assert r["grad_err"] <= tol["grads"]
        assert abs(r["loss0"]["flash"] - r["loss0"]["local"]) \
            <= tol["loss0"] * abs(r["loss0"]["local"])
    control = chip_smoke.step0_parity(torch, args, cfg, 0,
                                      chip_smoke.drop_query_head(sound))
    assert control["grad_err"] > tol["grads"]
    assert fa.flash_dkv is sound


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118masked_reduce_vec4EPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118masked_reduce_vec4EPKfPfi
    40 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    rows = chip_smoke.ptxas_kernels(PTXAS.format(spill=0))
    assert [(r["registers"], r["stack"], r["spill_stores"],
             r["spill_loads"]) for r in rows] == [(168, 0, 0, 0),
                                                 (255, 40, 36, 36)]
    assert "flash_fwd_mma_kernel" in rows[0]["kernel"]


def mma_report(lib: str, spill: int = 0, drop: str = "") -> str:
    """A ptxas report of every tensor-core kernel that ``lib`` must build
    (``chip_smoke.MMA_KERNELS`` at every head dim of ``HEAD_DIMS``), the
    first spilling ``spill`` bytes, ``drop`` (``name<d>``) left out."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for name in chip_smoke.MMA_KERNELS[lib]:
        for d in HEAD_DIMS:
            if drop == f"{name}<{d}>":
                continue
            mangled = (f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{d}EEEvPK13"
                       f"__nv_bfloat16")
            lines += [
                f"ptxas info    : Compiling entry function '{mangled}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {mangled}",
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads",
                "ptxas info    : Used 226 registers, used 1 barriers"]
            spill = 0
    return "\n".join(lines)


@pytest.mark.parametrize("spill,ok", [(0, True), (8, False)])
def test_a_spilling_tensor_core_kernel_fails_the_build_phase(spill, ok):
    """Only the ``*_mma_kernel`` entries are held to no spills (the
    other kernel of PTXAS, off the tensor cores, spills and passes)."""
    other = PTXAS.format(spill=0).splitlines()[5:]  # masked_reduce_vec4
    report = "\n".join([mma_report("flash_attention", spill), *other])
    info = {"flash_attention": {"seconds": 9.0, "ptxas": report}}
    if ok:
        rows = chip_smoke.check_mma_spills(info)
        assert len(rows) == 6 * len(HEAD_DIMS)
        assert {r["library"] for r in rows} == {"flash_attention"}
    else:
        with pytest.raises(AssertionError, match="spill"):
            chip_smoke.check_mma_spills(info)


@pytest.mark.parametrize("drop", [
    "", "ring_dq_mma_kernel<64>", "ring_dq_mma_kernel<128>",
    "ring_dkv_mma_kernel<64>", "ring_dkv_mma_kernel<128>",
    "ring_dq_tf32_mma_kernel<64>", "ring_dq_tf32_mma_kernel<128>",
    "ring_dkv_tf32_mma_kernel<64>", "ring_dkv_tf32_mma_kernel<128>",
    "ring_fwd_mma_kernel<32>", "ring_dq_mma_kernel<32>",
    "ring_dkv_tf32_mma_kernel<32>", "ring_fwd_tf32_mma_kernel<32>",
    "ring_fwd_tf32_mma_kernel<64>", "ring_fwd_tf32_mma_kernel<128>"])
def test_a_ring_library_without_a_backward_tensor_core_kernel_fails(drop):
    """The ring's forward, dq and dk/dv must be built on the tensor cores
    at every head dim (32, 64, 128), in bf16 and in f32 (split TF32); a
    report with all eighteen ring kernels passes."""
    info = {"ring_flash": {"seconds": 9.0,
                           "ptxas": mma_report("ring_flash", drop=drop)},
            "paged_attention": {"seconds": 0.0, "ptxas": ""}}
    if not drop:
        assert len(chip_smoke.check_mma_spills(info)) == 6 * len(HEAD_DIMS)
        return
    with pytest.raises(AssertionError, match="no tensor-core kernel") as e:
        chip_smoke.check_mma_spills(info)
    assert drop in str(e.value)


@pytest.mark.parametrize("drop", [
    "", "flash_dq_mma_kernel<64>", "flash_dkv_mma_kernel<128>",
    "flash_dq_tf32_mma_kernel<64>", "flash_dq_tf32_mma_kernel<128>",
    "flash_dkv_tf32_mma_kernel<64>", "flash_dkv_tf32_mma_kernel<128>",
    "flash_fwd_mma_kernel<32>", "flash_dkv_mma_kernel<32>",
    "flash_dq_tf32_mma_kernel<32>", "flash_fwd_tf32_mma_kernel<32>",
    "flash_fwd_tf32_mma_kernel<64>", "flash_fwd_tf32_mma_kernel<128>"])
def test_a_flash_library_without_a_backward_tensor_core_kernel_fails(drop):
    """The flash forward, dq and dk/dv must be built on the tensor cores
    at every head dim (32, 64, 128), in bf16 and in f32 (split TF32); a
    report with all eighteen flash kernels passes."""
    info = {"flash_attention": {
        "seconds": 9.0, "ptxas": mma_report("flash_attention", drop=drop)}}
    if not drop:
        assert len(chip_smoke.check_mma_spills(info)) == 6 * len(HEAD_DIMS)
        return
    with pytest.raises(AssertionError, match="no tensor-core kernel") as e:
        chip_smoke.check_mma_spills(info)
    assert drop in str(e.value)


def test_a_flash_library_without_tensor_core_kernels_fails():
    cuda_cores = PTXAS.format(spill=0).replace("flash_fwd_mma_kernel",
                                               "flash_fwd_kernel")
    info = {"ring_flash": {"seconds": 9.0, "ptxas": cuda_cores},
        "paged_attention": {"seconds": 0.0, "ptxas": ""}}
    with pytest.raises(AssertionError, match="no tensor-core kernel"):
        chip_smoke.check_mma_spills(info)


# -- phase 18: the ipc rank transport -----------------------------------------

def test_transport_cases_cover_every_collective_dtype_and_line():
    """Every spawn of phase 18 runs the four collectives in f32, bf16 and
    int8 on the world and, on the (2, 2) mesh, on both lines; each pair
    moves one chunk and 12 bytes (two chunks, the last ragged), its
    inputs made on the ranks from seeds that differ by case."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    tr = chip_smoke.transport_ranks()
    spawns = chip_smoke.TRANSPORT_SPAWNS
    assert {w for w, _ in spawns} == {2, 3, 4} and (4, 2) in spawns
    for world, sp in spawns:
        cases = chip_smoke.transport_cases(world, sp, 5)
        scopes = {"world"} | ({"sp", "dp"} if 1 < sp < world else set())
        assert {c[0] for c in cases} == scopes
        for scope in scopes:
            mine = [c for c in cases if c[0] == scope]
            assert {c[1] for c in mine} == set(transport.COLLECTIVES)
            assert {c[2] for c in mine} == {"float32", "bfloat16", "int8"}
        assert len({c[3].seed for c in cases}) == len(cases)
        for scope, kind, dtype, xs, _ in cases:
            assert isinstance(xs, tr.Seeded)
            n = tr.scope_size(world, sp, scope)
            elems = xs.shape[-1]
            assert xs.shape == ((n, elems) if kind == "all_to_all"
                                else (elems,))
            pair = elems * torch.tensor([], dtype=getattr(
                torch, dtype)).element_size()
            assert pair == transport.CHUNK_BYTES + 12
            assert transport.chunk_count(pair) == 2


def test_transport_timings_take_the_sync_at_the_flagship():
    timed = {t[0]: t for t in chip_smoke.transport_timed(2)}
    assert timed["sync_all_to_all"][1:] == ("all_to_all", "float32",
                                            541_130_752 // 2)
    assert timed["metrics_all_gather"][3] == 3


@pytest.mark.parametrize("kind,n,function,copies", [
    ("all_to_all", 2, 2 * (200 + 200), 2 * (4 * 100 + 2 * 100)),
    ("all_gather", 4, 4 * (100 + 400), 4 * (4 * 300 + 2 * 100)),
    ("exchange", 2, 2 * 200, 2 * 4 * 100),
    ("ppermute", 3, 3 * 200, 3 * 4 * 100)])
def test_transport_bound_counts_push_pull_and_local_bytes(kind, n, function,
                                                          copies):
    """The function's bytes (each rank's input read and output written
    once) and the schedule's copies' bytes, of a pair of 100 bytes."""
    b = chip_smoke.transport_bounds(kind, n, 100)
    assert (b["function_bytes"], b["copies_bytes"]) == (function, copies)
    rate = chip_smoke.PEAK_BYTES_PER_S
    assert b["function_ms"] == pytest.approx(function / rate * 1e3)
    assert b["copies_ms"] == pytest.approx(copies / rate * 1e3)


def test_the_sync_all_to_all_bound_is_its_input_and_output():
    """2.16 GB a rank at two ranks: 2 x (2.16 + 2.16) GB over 3.35 TB/s,
    2.585 ms; the schedule's copies move 1.5 times that."""
    b = chip_smoke.transport_bounds("all_to_all", 2, 541_130_752 // 2 * 4)
    assert b["function_ms"] == pytest.approx(2.585, abs=1e-3)
    assert b["copies_ms"] == pytest.approx(1.5 * b["function_ms"])


def fake_transport_rank(world, sp, rank, fault):
    """What ``transport_rank`` returns, sound unless ``fault`` says."""
    from akka_allreduce_tpu_torch.ops.kernels import ring
    first = (world, sp) == chip_smoke.TRANSPORT_SPAWNS[0]
    cases = [{"scope": c[0], "kind": c[1], "dtype": c[2],
              "pair_bytes": 100, "bitwise": True, "ipc_ms": 1.0,
              "gloo_ms": 50.0, "copies": 3, "launches": 2, "waits": 2}
             for c in chip_smoke.transport_cases(world, sp, 1)]
    if fault == "not_bitwise" and rank == 1:
        cases[-1]["bitwise"] = False
    out = {"rank": rank, "cases": cases, "buffers": []}
    if first:
        big = 541_130_752 // 2 * 4
        cases.append({**cases[0], "kind": "all_to_all", "pair_bytes": big,
                      "gloo_ms": 3000.0})
        out["timings"] = [{"label": "sync_all_to_all", "kind": "all_to_all",
                           "dtype": "float32", "pair_bytes": big,
                           "ms_per_rank": [9.0, 10.0], "ms": 10.0,
                           "received_gb_per_s": 108.0,
                           "bound_bytes": 1, "bound_ms": 2.6,
                           "copies_bound_bytes": 1,
                           "copies_bound_ms": 3.9}]
        if rank == 1:
            out["fault"] = {"skipped": True}
        else:
            late = ring.TIMEOUT_S + 5 if fault == "late" else 30.1
            out["fault"] = (
                {"raised": False} if fault == "not_raised" else
                {"raised": True, "seconds": late,
                 "message": "ipc transport: ... ready from rank 1 = 1 "
                            "(needs >= 2) ... abandoned"})
    return out


@pytest.mark.parametrize("fault", ["none", "not_bitwise", "not_raised",
                                   "late"])
def test_phase18_passes_only_without_a_fault(monkeypatch, capfd, fault):
    """Phase 18's verdict from its ranks' outputs (the spawn replaced):
    sound ranks pass and give the kernels line its transport entry with
    every key, its bound the function's; a case that is not bitwise
    gloo, and a fault control that did not raise, or raised late, each
    fail it."""
    from akka_allreduce_tpu_torch.parallel import group as group_mod

    def fake_spawn(fn, world, backend, device, *args, sp=1, timeout=None):
        assert fn is chip_smoke.transport_rank and backend == "ipc"
        return [fake_transport_rank(world, sp, r, fault)
                for r in range(world)]
    monkeypatch.setattr(group_mod, "spawn_ranks", fake_spawn)
    if fault != "none":
        with pytest.raises(AssertionError, match="transport"):
            chip_smoke.phase_transport(torch)
        return
    runs = chip_smoke.phase_transport(torch)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "transport"')]
    assert [(ln["world"], ln["sp"]) for ln in lines] == list(
        chip_smoke.TRANSPORT_SPAWNS)
    assert lines[0]["timings"][0]["ms"] == 10.0
    row = chip_smoke.transport_kernel_row(runs, 123)
    assert set(row) == KERNEL_KEYS
    assert (row["launches"], row["ms"], row["plain_ms"], row["bound_ms"],
            row["bound_by"], row["library_ms"]) == (123, 10.0, 3000.0, 2.6,
                                                    "bytes", None)


@pytest.mark.parametrize("fault", ["none", "host_copy", "untraced",
                                   "missing"])
def test_phase9_sync_traces_hold_no_host_copy(fault):
    """Phase 9's traced step-1 syncs: each rank's window must hold the
    transport's kernels and no host-device copy above 1 MB."""
    sound = {"host_copies": [{"name": "Memcpy DtoH (Device -> Pinned)",
                              "bytes": 8}],
             "transport_kernels": 40, "largest_host_copy_bytes": 8}
    bad = {"none": sound,
           "host_copy": {**sound, "largest_host_copy_bytes": 2 << 20},
           "untraced": {**sound, "transport_kernels": 0},
           "missing": None}[fault]
    ranks = [{"sync_trace": sound}, {"sync_trace": bad}]
    if fault == "none":
        chip_smoke.check_sync_traces("t", ranks)
    else:
        with pytest.raises(AssertionError, match="traced ipc sync"):
            chip_smoke.check_sync_traces("t", ranks)


def fake_report(backend, losses, launches, checksum=7, peak=10.0):
    rank = {"sync_ms": [5.0, 4.0], "attn_exchange_ms": [0.0, 0.0],
            "peak_memory_gb": peak, "transport_buffer_gb": 0.134,
            "param_checksum": checksum, "residual_checksum": checksum,
            "transport": {"transport_launches": launches}}
    return {"losses": losses, "wall_ms_per_step": 100.0,
            "dist": {"backend": backend, "world": 2},
            "ranks": [dict(rank), dict(rank)]}


@pytest.mark.parametrize("twin_losses,twin_sum,twin_peak,launches,ok", [
    ([1.5, 1.25], 7, 10.0, 40, True),      # every step, bitwise
    ([1.5], 99, 10.0, 40, True),           # a shorter twin: losses only
    ([1.5, 1.2500001], 7, 10.0, 40, False),  # a loss that moved
    ([1.5, 1.25], 8, 10.0, 40, False),     # parameters that moved
    ([1.5, 1.25], 7, 9.0, 40, False),      # an ipc peak above the twin's
    ([1.5, 1.25], 7, 10.0, 0, False)])     # the run never rode ipc
def test_a_twin_must_match_its_ipc_run_bitwise(twin_losses, twin_sum,
                                               twin_peak, launches, ok):
    report = fake_report("ipc", [1.5, 1.25], launches)
    twin = fake_report("gloo", twin_losses, 0, twin_sum, twin_peak)
    fields = chip_smoke.twin_fields(report, twin, 12.0)
    assert fields["twin_steps"] == len(twin_losses)
    if ok:
        chip_smoke.check_twin("t", report, fields, peak=True)
    else:
        with pytest.raises(AssertionError, match="gloo twin"):
            chip_smoke.check_twin("t", report, fields, peak=True)


# -- phase 19: the protocol plane --------------------------------------------

TINY_PROTOCOL = {
    "a": ["emulate", "--workers", "4", "--data-size", "26",
          "--max-chunk-size", "3", "--max-lag", "3", "--max-round", "12",
          "--checkpoint", "5", "--th-complete", "1.0",
          "--assert-multiple", "4"],
    "b": ["emulate", "--workers", "4", "--data-size", "26",
          "--max-chunk-size", "3", "--max-lag", "3", "--max-round", "12",
          "--th-allreduce", "0.75", "--th-reduce", "0.75",
          "--th-complete", "0.75", "--kill-rank", "1"],
    "c": ["emulate", "--workers", "2", "--data-size", "96",
          "--max-chunk-size", "16", "--max-lag", "1", "--th-complete",
          "1.0", "--max-round", "3", "--checkpoint", "1"],
    "d": ["emulate", "--fuzz", "2", "--workers", "3", "--data-size", "15",
          "--max-round", "3", "--assert-multiple", "3", "--th-complete",
          "1.0"]}


def test_phase19_rehearsal(monkeypatch, capfd):
    """Phase 19 at a tiny size on the CPU (the card's run on the CPU
    twin's device, so no launch is counted): every part passes its
    checks, (a) and (b) bitwise their twins, one line a part."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "PROTOCOL_PARTS", TINY_PROTOCOL)
    monkeypatch.setattr(chip_smoke, "PROTOCOL_PUMP_BITE", 1)
    out = chip_smoke.phase_protocol(torch, n_params=1000)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()]
    parts = [ln["part"] for ln in lines if ln["phase"] == "protocol"]
    assert parts == ["a", "b", "c", "d"]
    a, b, c, d = (out["lines"][p] for p in "abcd")
    assert a["bitwise_twin"] and b["bitwise_twin"]
    assert a["rounds"] == b["rounds"] == 12 and c["rounds"] == 3
    assert a["flushes"] == [13] * 4 and b["flushes"][1] == 0
    assert len(a["sink_mb_per_s"]) == 2 and len(c["sink_mb_per_s"]) == 3
    assert len(c["round_s"]) == 3 and c["run_s"] >= sum(c["round_s"])
    assert c["rounds_per_s"] == pytest.approx(3 / c["run_s"])
    assert c["profile"]["round"] == 1 and c["profile"]["messages"] > 0
    assert d["violations"] == 0 and d["schedules"] == 4 + 5 + 2
    # the CPU runs the plain reduce: nothing launched, nothing expected
    # of the counter; the tracer still sees every fired reduce
    assert out["launches"] == 0 and a["reduce_fired"] > 0
    # 26 floats in blocks of 7, 7, 7, 5: 3 + 3 + 3 + 2 chunk reduces a
    # round, 13 flushed rounds
    assert a["expected_launches"] == a["reduce_fired"] == 11 * 13


def test_phase19_parts_build_c_from_phase9s_gradient():
    parts = chip_smoke.protocol_parts(541_130_700)
    c = parts["c"]
    assert c[c.index("--data-size") + 1] == str(8257 * 65536)
    assert c[c.index("--max-chunk-size") + 1] == "65536"
    assert parts["a"] == chip_smoke.PROTOCOL_PARTS["a"]


def test_phase19_twin_check_sees_one_bit():
    base = {0: [(0, torch.arange(4.0), torch.full((4,), 2,
                                                  dtype=torch.int32))]}
    flipped = torch.arange(4.0)
    flipped.view(torch.int32)[1] ^= 1
    assert chip_smoke.same_flushes(base, {0: [(0, torch.arange(4.0),
                                               base[0][0][2])]})
    assert not chip_smoke.same_flushes(base, {0: [(0, flipped,
                                                   base[0][0][2])]})
    assert not chip_smoke.same_flushes(base, {0: []})


def test_phase19_expected_launches_count_catchup_chunks():
    """One launch per fired reduce, plus one per chunk of the worker's
    block for each force-completed round (the catch-up reduces every
    chunk, fired or not)."""
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    tracer = Tracer()
    for _ in range(5):
        tracer.record("reduce_fired", worker=0, round=0, chunk=0,
                      contributors=2)
    tracer.record("catchup_force_complete", worker=1, round=0, behind=4)
    tracer.record("catchup_force_complete", worker=0, round=1, behind=4)
    cluster = types.SimpleNamespace(workers=[
        types.SimpleNamespace(scatter_block_buf=types.SimpleNamespace(
            num_chunks=k)) for k in (3, 7)])
    assert chip_smoke.expected_reduce_launches(tracer, cluster) == 5 + 7 + 3


def test_phase20_argvs():
    """Each part's processes: (a) 4 card workers under the Python master
    (traced), (b) two of them C++ workers, (c) the C++ master, (d) phase
    19 (c)'s shape with a 120 s liveness window on every process, (e)
    lossy with the checkpoint at the kill round; every card worker checks
    every flush, traces, and prints its report."""
    parts = {p: chip_smoke.cluster_argvs(p, 541_130_752, 9, "/t")
             for p in chip_smoke.CLUSTER_PARTS}
    for part, (master, workers) in parts.items():
        engines = chip_smoke.CLUSTER_PARTS[part][1]
        assert [e for e, _ in workers] == engines
        assert master[master.index("--workers") + 1] == str(len(engines))
        assert ("--native" in master) == (part == "c")
        assert ("--trace-file" in master) == (part != "c")
        for engine, argv in workers:
            assert argv[:3] == ["worker", "--master-port", "9"]
            assert "--verbose" in argv and "--device" not in argv
            if engine == "native":
                assert "--native" in argv and "--trace-file" not in argv
            else:
                assert "--assert-honest" in argv and "--trace-file" in argv
            assert ("--assert-multiple" in argv) == (part != "e")
    d_master, d_workers = parts["d"]
    assert d_master[d_master.index("--data-size") + 1] == str(8257 * 65536)
    assert d_master[d_master.index("--max-chunk-size") + 1] == "65536"
    for argv in [d_master] + [a for _, a in d_workers]:
        assert argv[argv.index("--unreachable-after") + 1] == "120"
    e_master, e_workers = parts["e"]
    assert e_master[e_master.index("--th-reduce") + 1] == "0.75"
    assert all(a[a.index("--checkpoint") + 1] == "10" for _, a in e_workers)
    assert [parts[p][0][parts[p][0].index("--max-round") + 1]
            for p in "abcde"] == ["100", "25", "25", "3", "25"]


def test_phase20_worker_launches_from_its_trace():
    """A card worker's expected launches: its trace's reduces, plus its
    block's chunks for each force-completed round."""
    proc = types.SimpleNamespace(
        p=types.SimpleNamespace(returncode=0),
        lines=["worker: joined as rank 1", "0.0 MB in 0.1s at 0.050 MB/s",
               "worker 1: 3 outputs",
               'worker 1: report {"rank": 1, "outputs": 3, '
               '"masked_reduce_launches": 12}'])
    trace = [{"kind": "reduce_fired", "ts": 0.0}] * 5 + [
        {"kind": "catchup_force_complete", "ts": 0.0},
        {"kind": "round_complete", "ts": 1.0},
        {"kind": "round_complete", "ts": 2.0}]
    got = chip_smoke.worker_result(proc, "card", trace, [4, 7])
    assert got["expected_launches"] == 5 + 7
    assert got["masked_reduce_launches"] == 12
    assert got["sink_mb_per_s"] == [0.05]
    assert got["worker_rounds_per_s"] == 1.0


def test_phase20_rehearsal(monkeypatch, capfd):
    """Phase 20 at a tiny size on the CPU (card workers on ``--device
    cpu``, so no launch is counted): the mixed engines and the kill part
    pass their checks, (f) runs the C++ engine."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CLUSTER_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CLUSTER_COPY_REPS", 3)
    monkeypatch.setattr(chip_smoke, "CLUSTER_PARTS", {
        "b": chip_smoke.CLUSTER_PARTS["b"],
        "e": chip_smoke.CLUSTER_PARTS["e"]})
    monkeypatch.setattr(chip_smoke, "CLUSTER_ROUNDS",
                        {"a": 20, "b": 12, "e": 16})
    out = chip_smoke.phase_cluster(torch, n_params=1000)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()]
    parts = [ln["part"] for ln in lines if ln["phase"] == "cluster"]
    assert parts == ["copies", "b", "e", "f"]
    assert out["lines"]["b"]["rounds"] == 12
    assert out["lines"]["b"]["worker_rcs"] == [0, 0, 0, 0]
    e = out["lines"]["e"]
    assert e["rounds"] == 16 and len(e["downs_at_round"]) == 1
    assert sorted(e["worker_rcs"]) == [-9, 0, 0, 0]
    assert out["lines"]["f"]["rounds"] == 20
    assert out["launches"] == 0
