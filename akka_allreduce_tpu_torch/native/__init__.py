"""Native (C++) runtime components: the host transport and engines.

Counterpart of ``akka_allreduce_tpu/native/``. The reference's transport
layer is JVM-native netty TCP under Akka remoting (reference:
application.conf:5-11); this package supplies the equivalent for the
port's host plane: a C++ framed TCP transport (``src/transport.cpp``),
the in-process C++ cluster (``src/cluster.cpp``) and the C++ master and
worker engines (``src/remote_master.cpp``, ``src/remote_worker.cpp``),
loaded through ctypes and built on first use with the in-tree Makefile
(g++; no pybind11).

The sources are a copy of the JAX package's, kept byte for byte: host
code, no kernel. The library has a name of its own (``libaatpu_torch.so``)
so that both packages' libraries can live in one process (ctypes loads
each with ``RTLD_LOCAL``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_lib", "libaatpu_torch.so")
_SRCS = [os.path.join(_DIR, "src", f)
         for f in ("transport.cpp", "cluster.cpp", "remote_worker.cpp",
                   "remote_master.cpp", "ring.h", "wire_codec.h",
                   "worker_core.h")]

_lib: ctypes.CDLL | None = None


def _stale() -> bool:
    makefile = os.path.join(_DIR, "Makefile")
    src_mtime = max([os.path.getmtime(s) for s in _SRCS]
                    + [os.path.getmtime(makefile)])
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime


def build_library(force: bool = False) -> str:
    """Compile the shared library if missing or older than its source.
    Returns the .so path; a failed build raises ``RuntimeError`` with the
    compiler's output.

    Safe across processes: a build holds a file lock, so concurrent cold
    starts (the test workers, a cluster's processes) build once and the
    others wait and reuse the result; the build goes to a per-pid temp
    file that is atomically renamed, so no process ever loads a
    partially written .so."""
    if not force and not _stale():
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(os.path.join(os.path.dirname(_SO), ".build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if force or _stale():
                tmp = f"{_SO}.tmp.{os.getpid()}"
                try:
                    # through the in-tree Makefile so its CXX/CXXFLAGS
                    # overrides apply on the automatic path too
                    out = subprocess.run(
                        ["make", "-s", "-C", _DIR,
                         f"OUT={os.path.relpath(tmp, _DIR)}"],
                        capture_output=True, text=True)
                    if out.returncode != 0:
                        raise RuntimeError(
                            f"building {_SO} failed (make exit "
                            f"{out.returncode}):\n{out.stdout}{out.stderr}")
                    os.replace(tmp, _SO)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return _SO


def load_library() -> ctypes.CDLL:
    """Load (building if needed) and configure the C ABI."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())

    lib.aat_create.restype = ctypes.c_void_p
    lib.aat_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.aat_port.restype = ctypes.c_int
    lib.aat_port.argtypes = [ctypes.c_void_p]
    lib.aat_connect.restype = ctypes.c_int
    lib.aat_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_int]
    lib.aat_send.restype = ctypes.c_int
    lib.aat_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_uint8),
                             ctypes.c_uint64]
    lib.aat_recv_len.restype = ctypes.c_int64
    lib.aat_recv_len.argtypes = [ctypes.c_void_p]
    lib.aat_recv_take.restype = ctypes.c_int64
    lib.aat_recv_take.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.aat_poll_disconnect.restype = ctypes.c_int
    lib.aat_poll_disconnect.argtypes = [ctypes.c_void_p]
    lib.aat_close_peer.restype = None
    lib.aat_close_peer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aat_send_drained.restype = ctypes.c_int
    lib.aat_send_drained.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aat_num_connected.restype = ctypes.c_int
    lib.aat_num_connected.argtypes = [ctypes.c_void_p]
    lib.aat_destroy.restype = None
    lib.aat_destroy.argtypes = [ctypes.c_void_p]

    lib.aat_cluster_run.restype = ctypes.c_long
    lib.aat_cluster_run.argtypes = [
        ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_long)]

    lib.aat_cluster_run_timed.restype = ctypes.c_long
    lib.aat_cluster_run_timed.argtypes = [
        ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long]

    lib.aat_remote_worker_run.restype = ctypes.c_long
    lib.aat_remote_worker_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int]

    lib.aat_remote_worker_run_seeds.restype = ctypes.c_long
    lib.aat_remote_worker_run_seeds.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int]

    lib.aat_remote_master_run.restype = ctypes.c_long
    lib.aat_remote_master_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int]

    lib.aat_remote_master_run_timed.restype = ctypes.c_long
    lib.aat_remote_master_run_timed.argtypes = \
        lib.aat_remote_master_run.argtypes + [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long]

    _lib = lib
    return lib
