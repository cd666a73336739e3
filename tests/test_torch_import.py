"""The PyTorch port stands alone: it never loads JAX or the JAX package.

Three pins: a fresh interpreter imports every module of
``akka_allreduce_tpu_torch`` (the CLI, the gradient sync's, the ring
attention's, the peer-memory allreduce's, the round pacer's, the
deadline trainer's, the collective autotuner's, the rank transport's,
the pipeline schedules',
the bench rows' and the protocol plane's modules included, the
optimizer families, the MLP and the telemetry's, the serving fault
injection and preemption watcher, the wire
codec, the TCP router, the remote runners, the C++ cluster, the
store-backed KV client and router, the coordinator, the DCN trainer and
the elastic re-formation, and the
``native`` loader among them) and finds neither ``jax`` nor
``akka_allreduce_tpu`` in ``sys.modules``, nor, once it has loaded the
port's C++ library, the JAX package's library among its mappings; a rank process that
``spawn_ranks`` starts from this (JAX-importing) test process holds
neither either; and an AST scan of the package's sources finds no
import statement naming either.
"""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "akka_allreduce_tpu_torch"


def _modules() -> list:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"akka_allreduce_tpu_torch.cli",
            "akka_allreduce_tpu_torch.data",
            "akka_allreduce_tpu_torch.models.flops",
            "akka_allreduce_tpu_torch.models.train",
            "akka_allreduce_tpu_torch.ops.kernels.flash_attention",
            "akka_allreduce_tpu_torch.runtime.checkpoint",
            "akka_allreduce_tpu_torch.runtime.pacer",
            "akka_allreduce_tpu_torch.runtime.straggler",
            "akka_allreduce_tpu_torch.runtime.faults",
            "akka_allreduce_tpu_torch.runtime.preempt",
            "akka_allreduce_tpu_torch.parallel.group",
            "akka_allreduce_tpu_torch.parallel.dp",
            "akka_allreduce_tpu_torch.parallel.pp",
            "akka_allreduce_tpu_torch.ops.bucketing",
            "akka_allreduce_tpu_torch.ops.masked",
            "akka_allreduce_tpu_torch.ops.collectives",
            "akka_allreduce_tpu_torch.ops.kernels.masked_reduce",
            "akka_allreduce_tpu_torch.ops.kernels.quantized",
            "akka_allreduce_tpu_torch.ops.kernels.ring_flash",
            "akka_allreduce_tpu_torch.ops.kernels.ring",
            "akka_allreduce_tpu_torch.ops.kernels.transport",
            "akka_allreduce_tpu_torch.parallel.ring_attention",
            "akka_allreduce_tpu_torch.ops.autotune",
            "akka_allreduce_tpu_torch.bench",
            "akka_allreduce_tpu_torch.config",
            "akka_allreduce_tpu_torch.messages",
            "akka_allreduce_tpu_torch.buffers",
            "akka_allreduce_tpu_torch.buffers.base",
            "akka_allreduce_tpu_torch.buffers.scattered",
            "akka_allreduce_tpu_torch.buffers.reduced",
            "akka_allreduce_tpu_torch.runtime.tracing",
            "akka_allreduce_tpu_torch.protocol",
            "akka_allreduce_tpu_torch.protocol.transport",
            "akka_allreduce_tpu_torch.protocol.worker",
            "akka_allreduce_tpu_torch.protocol.master",
            "akka_allreduce_tpu_torch.protocol.cluster",
            "akka_allreduce_tpu_torch.protocol.explorer",
            "akka_allreduce_tpu_torch.protocol.wire",
            "akka_allreduce_tpu_torch.protocol.tcp",
            "akka_allreduce_tpu_torch.protocol.remote",
            "akka_allreduce_tpu_torch.protocol.native_cluster",
            "akka_allreduce_tpu_torch.protocol.kv",
            "akka_allreduce_tpu_torch.runtime.coordinator",
            "akka_allreduce_tpu_torch.runtime.dcn_train",
            "akka_allreduce_tpu_torch.runtime.elastic",
            "akka_allreduce_tpu_torch.native",
            "akka_allreduce_tpu_torch.models.optim",
            "akka_allreduce_tpu_torch.models.mlp",
            "akka_allreduce_tpu_torch.telemetry.device",
            "akka_allreduce_tpu_torch.telemetry.registry"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'akka_allreduce_tpu' "
        "or m.startswith('akka_allreduce_tpu.'))\n"
        "from akka_allreduce_tpu_torch.native import load_library\n"
        "load_library()\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad += sorted({ln.split()[-1] for ln in maps.splitlines()\n"
        "               if '/akka_allreduce_tpu/native/' in ln})\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _is_jax(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "akka_allreduce_tpu")


def test_spawned_rank_loads_no_jax():
    import jax  # noqa: F401 - the parent holds JAX; the ranks must not

    from akka_allreduce_tpu_torch.parallel.group import (run_calls,
                                                         spawn_ranks)
    target = "akka_allreduce_tpu_torch.parallel.group:loaded_modules"
    ranks = spawn_ranks(run_calls, 2, "gloo", "cpu", [(target, [], {})])
    for (mods,) in ranks:
        assert "akka_allreduce_tpu_torch.parallel.group" in mods
        assert [m for m in mods if _is_jax(m)] == []


def _imported_names(tree: ast.AST) -> list:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


def test_ast_scan_finds_no_jax_import():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    scanned = set()
    for path in files:
        scanned.add(path.relative_to(REPO).as_posix())
        for name in _imported_names(ast.parse(path.read_text())):
            if _is_jax(name):
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert offenders == []
    assert {f"akka_allreduce_tpu_torch/{m}.py" for m in (
        "parallel/group", "parallel/dp", "ops/bucketing", "ops/masked",
        "ops/collectives", "ops/kernels/masked_reduce",
        "ops/kernels/quantized", "ops/kernels/ring_flash",
        "ops/kernels/ring", "ops/kernels/transport",
        "parallel/ring_attention", "ops/autotune", "bench", "config",
        "messages", "buffers/base", "buffers/scattered", "buffers/reduced",
        "runtime/tracing", "protocol/transport", "protocol/worker",
        "protocol/master", "protocol/cluster", "protocol/explorer",
        "protocol/wire", "protocol/tcp", "protocol/remote",
        "protocol/native_cluster", "native/__init__", "protocol/kv",
        "runtime/coordinator", "runtime/dcn_train",
        "runtime/elastic")} <= scanned


def test_a_rank_that_loads_the_transport_loads_no_jax():
    """The ``ipc`` transport's module, imported in a spawned rank through
    the transport tests' rank helpers (its CUDA library is built only at
    a call, never at import)."""
    from akka_allreduce_tpu_torch.parallel.group import (run_calls,
                                                         spawn_ranks)
    calls = [("torch_transport_ranks:run_cases", [], {"cases": []}),
             ("akka_allreduce_tpu_torch.parallel.group:loaded_modules", [],
              {})]
    ranks = spawn_ranks(run_calls, 2, "gloo", "cpu", calls)
    for _, mods in ranks:
        assert "akka_allreduce_tpu_torch.ops.kernels.transport" in mods
        assert [m for m in mods if _is_jax(m)] == []
