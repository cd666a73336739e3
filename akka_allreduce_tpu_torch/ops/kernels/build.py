"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` into ``_build/lib<name>-<hash>.so`` and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
The hash covers the source, every ``csrc/`` header it reaches through
``#include "..."`` (nested includes too), and the flags, so an edited
source or header rebuilds and an unchanged one is reused. Builds run at
first use, never at import: the package imports on machines without
``nvcc`` or a GPU, where only the kernels' plain versions run.

A failed compile or a library that does not load raises; nothing falls
back to the plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a (not sm_90): the Hopper-only instructions (wgmma, setmaxnreg)
# exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("paged_attention", "flash_attention", "masked_reduce", "quantize",
           "ring_flash", "ring_allreduce", "transport")

_LIBS: dict = {}
# per kernel: {"seconds": build wall time (0.0 when reused), "ptxas": the
# compiler's register / shared-memory report}
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels cannot be built on this machine")


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` header it reaches through
    ``#include "..."``, nested includes too: each file once, depth first
    in include order."""
    seen: list = []
    todo = [f"{name}.cu"]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        text = (CSRC_DIR / rel).read_bytes()
        incs = re.findall(rb'#include "([^"]+)"', text)
        todo += [inc.decode() for inc in reversed(incs)]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join((CSRC_DIR / rel).read_bytes() for rel in sources(name))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name``; None when the library is current."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return
    proc, tmp, out, t0 = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{stdout}{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": stderr.strip()}


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel, one nvcc each, all started together.
    Returns ``BUILD_INFO``."""
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
