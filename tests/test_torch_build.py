"""The kernel build's content hash, on the CPU (no nvcc is needed: only
the library's path is computed, nothing is compiled).

``build.library_path`` names a library by a hash of its source, every
``csrc/`` header the source reaches through ``#include "..."`` (nested
includes too) and the nvcc flags, so an edited header anywhere under a
source rebuilds that source's library, and nothing else does.
"""

import shutil

import pytest

from akka_allreduce_tpu_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc tree: a.cu includes b.cuh, which includes c.cuh; d.cu
    stands alone."""
    files = {
        "a.cu": '#include "b.cuh"\n#include <cuda_runtime.h>\nint a;\n',
        "b.cuh": '#pragma once\n#include "c.cuh"\nint b;\n',
        "c.cuh": "#pragma once\nint c;\n",
        "d.cu": "int d;\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    return tmp_path


def test_sources_follow_nested_includes(csrc):
    assert build.sources("a") == ["a.cu", "b.cuh", "c.cuh"]
    assert build.sources("d") == ["d.cu"]


def test_a_header_included_twice_is_read_once(csrc):
    (csrc / "a.cu").write_text('#include "b.cuh"\n#include "c.cuh"\n')
    assert build.sources("a") == ["a.cu", "b.cuh", "c.cuh"]


@pytest.mark.parametrize("edited,changes", [("c.cuh", True),
                                            ("b.cuh", True),
                                            ("d.cu", False)])
def test_editing_a_reached_header_changes_the_library(csrc, edited,
                                                      changes):
    before = build.library_path("a")
    assert build.library_path("a") == before  # the hash is stable
    with open(csrc / edited, "a") as f:
        f.write("int edited;\n")
    assert (build.library_path("a") != before) is changes


def test_ring_flash_reaches_both_tile_headers():
    """On the real csrc tree: both flash libraries reach the split-TF32
    folds (flash_tf32.cuh, the f32 kernels), through them the bf16
    tensor-core tiles (flash_mma.cuh) and through those the geometry,
    masks and launch code (flash_tiles.cuh)."""
    headers = ["flash_tf32.cuh", "flash_mma.cuh", "flash_tiles.cuh"]
    assert build.sources("flash_attention") == ["flash_attention.cu",
                                                *headers]
    assert build.sources("ring_flash") == ["ring_flash.cu", *headers]


@pytest.mark.parametrize("edited", ["flash_mma.cuh", "flash_tiles.cuh",
                                    "flash_tf32.cuh"])
def test_editing_a_tile_header_rebuilds_both_flash_libraries(
        tmp_path, monkeypatch, edited):
    """A copy of the real csrc tree: an edit to a shared tile header moves
    both flash libraries' paths and no other library's."""
    shutil.copytree(build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    before = {n: build.library_path(n) for n in build.KERNELS}
    with open(tmp_path / "csrc" / edited, "a") as f:
        f.write("// edited\n")
    moved = {n for n in build.KERNELS if build.library_path(n) != before[n]}
    assert moved == {"flash_attention", "ring_flash"}


def test_the_transport_and_the_peer_allreduce_share_the_peer_memory_header():
    """Both peer-memory libraries reach ``csrc/peer_mem.cuh`` (the IPC
    buffers, the stream wait, the abandon path and the signal's ticket),
    and nothing else does."""
    assert build.sources("transport") == ["transport.cu", "peer_mem.cuh"]
    assert build.sources("ring_allreduce") == ["ring_allreduce.cu",
                                               "peer_mem.cuh"]
    assert "transport" in build.KERNELS


def test_editing_the_peer_memory_header_rebuilds_both_its_libraries(
        tmp_path, monkeypatch):
    shutil.copytree(build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    before = {n: build.library_path(n) for n in build.KERNELS}
    with open(tmp_path / "csrc" / "peer_mem.cuh", "a") as f:
        f.write("// edited\n")
    moved = {n for n in build.KERNELS if build.library_path(n) != before[n]}
    assert moved == {"ring_allreduce", "transport"}
