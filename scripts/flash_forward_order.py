#!/usr/bin/env python3
"""Time the bf16 tensor-core forward kernels in their launch order (query
tile ``blockIdx.x``, as the sources stand) against the heaviest query
tiles first.

    python3 scripts/flash_forward_order.py     # one NVIDIA GPU, repo root

Under a causal mask query tile i has i + 1 live key tiles, so launching
the longest blocks first (tile ``gridDim.x - 1 - blockIdx.x``, as the
bf16 dq kernel does) could let the short ones fill the tail. This script
builds ``csrc/flash_attention.cu`` and ``csrc/ring_flash.cu`` a second
time with ``flash_fwd_mma_kernel`` and ``ring_fwd_mma_kernel`` taking
their tiles that way (a copy of ``csrc/`` in a temporary directory, one
nvcc per source), then times both builds' forward launches in turns (as
built, heaviest first, heaviest first, as built; each a median of 20
single calls with the L2 flushed, ``chip_smoke.time_ms``): the flash
forward at the training slice's shape (B 8, T 2048, H 16, D 128, causal)
and the ring forward at the sequence-parallel slice's two hops (B 8,
T_local 1024, H 16, H_kv 4, D 128). Both orders' outputs must be bitwise
equal. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BUILT = "const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;"
HEAVY_FIRST = ("const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, "
               "h = blockIdx.y, b = blockIdx.z;")
KERNELS = ("flash_fwd_mma_kernel", "ring_fwd_mma_kernel")
ENTRIES = {"flash_attention": ("flash_fwd_launch", 5, "flash_error_string"),
           "ring_flash": ("ring_fwd_launch", 6, "ring_flash_error_string")}


def heavy_first_libraries(build, workdir: pathlib.Path) -> dict:
    """The two forward libraries built from a copy of csrc/ whose
    tensor-core forward kernels take the heaviest query tiles first;
    {name: bound entry points}."""
    src = workdir / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    procs = {}
    for name in ENTRIES:
        path = src / f"{name}.cu"
        text = path.read_text()
        kernel = next(k for k in KERNELS if k in text)
        start = text.index(f"\n{kernel}(")
        at = text.index(BUILT, start)
        path.write_text(text[:at] + HEAVY_FIRST + text[at + len(BUILT):])
        lib = workdir / f"lib{name}_heavy_first.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}{err}")
        fns[name] = bind(ctypes.CDLL(str(lib)), name)
    return fns


def bind(lib, name: str) -> dict:
    entry, n_ptrs, error = ENTRIES[name]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [i32, i32] + [ptr] * n_ptrs + [ptr, ctypes.c_float, ptr]
    fn.restype = i32
    err = getattr(lib, error)
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return {entry: fn, "error": err}


def main() -> int:
    import torch

    import chip_smoke
    from akka_allreduce_tpu_torch.ops.kernels import build
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    if not torch.cuda.is_available():
        print("flash_forward_order: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    built = {"flash_attention": fa._launchers(),
             "ring_flash": rf._launchers()}
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    cases = {
        "flash_fwd slice": ("flash_attention", 8, 2048, 16, 16, 0, 0),
        "ring_fwd slice-diagonal": ("ring_flash", 8, 1024, 16, 4, 1024, 1024),
        "ring_fwd slice-past": ("ring_flash", 8, 1024, 16, 4, 1024, 0)}
    with tempfile.TemporaryDirectory() as tmp:
        heavy = heavy_first_libraries(build, pathlib.Path(tmp))
        rows = {}
        for case, (lib, b, t, h, h_kv, q_off, k_off) in cases.items():
            q, k, v = (torch.randn((b, t, n, 128), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for n in (h, h_kv, h_kv))
            geom = fa.geometry(q, k, v, None, True, None, q_off, k_off)
            if lib == "flash_attention":
                outs = [torch.empty_like(q),
                        torch.empty((b, h, t), device="cuda")]
            else:
                outs = [torch.full((b, h, t), -1e30, device="cuda"),
                        torch.zeros((b, h, t), device="cuda"),
                        torch.zeros((b, t, h, 128), device="cuda")]
            entry = ENTRIES[lib][0]
            results = {}
            for order, fns in (("as_built", built[lib]),
                               ("heavy_first", heavy[lib])):
                state = [x.clone() for x in outs]
                fa.launch(fns, entry, q, [q, k, v, *state], geom)
                results[order] = state
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in
                       zip(results["as_built"], results["heavy_first"]))
            ms = {"as_built": [], "heavy_first": []}
            for order in ("as_built", "heavy_first", "heavy_first",
                          "as_built"):
                fns = built[lib] if order == "as_built" else heavy[lib]
                state = [x.clone() for x in outs]
                ms[order].append(chip_smoke.time_ms(torch, lambda: fa.launch(
                    fns, entry, q, [q, k, v, *state], geom), flush))
            rows[case] = {"ms": ms, "bitwise_equal": same}
            if not same:
                raise AssertionError(f"{case}: the launch order changed "
                                     f"the result")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    print(json.dumps({"forward_launch_order": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
