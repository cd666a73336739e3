"""The port's store client and router (``protocol/kv.py``) against the
JAX coordination service's surface.

``StoreKv`` over a real ``torch.distributed.TCPStore`` is driven call for
call beside ``tests/kv_fake.py FakeKvClient`` (the in-memory rendering
of the JAX client the JAX tests use): the same results, the same
``NOT_FOUND`` / ``ALREADY_EXISTS`` errors, the same directory reads.
Then what the fake cannot show: a value over the libuv server's 8 MiB
payload cap read whole, a reader that sees a value whole or not at all
while a writer overwrites and deletes it, a try-get that never waits on
a missing or deleted key, and the ``KvRouter`` across two processes
(per-sender FIFO and the member announcements).
"""

import datetime
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch.distributed as dist

from kv_fake import FakeKvClient

from akka_allreduce_tpu_torch.messages import CompleteAllreduce
from akka_allreduce_tpu_torch.protocol.kv import KvRef, KvRouter, StoreKv

REPO = pathlib.Path(__file__).resolve().parents[1]


def _server(use_libuv: bool = True):
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False, use_libuv=use_libuv,
                         timeout=datetime.timedelta(seconds=30))


@pytest.fixture(scope="module")
def server():
    return _server()


@pytest.fixture
def kv(server, request):
    # a fresh root per test: one server serves the module
    return StoreKv(server, root=f"t{abs(hash(request.node.name))}/")


def _outcome(fn, *args, **kw):
    """A call's result, or the error convention it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except RuntimeError as exc:
        for tag in ("NOT_FOUND", "ALREADY_EXISTS"):
            if tag in str(exc):
                return ("err", tag)
        raise


SCRIPT = [
    ("key_value_try_get", ("ns/a",), {}),
    ("key_value_set", ("ns/a", "1"), {}),
    ("key_value_try_get", ("ns/a",), {}),
    ("key_value_set", ("ns/a", "2"), {}),
    ("key_value_set", ("ns/a", "3"), {"allow_overwrite": True}),
    ("key_value_try_get", ("ns/a",), {}),
    ("key_value_set_bytes", ("ns/g/000001/0001/0000", b"\x00\x01"), {}),
    ("key_value_set_bytes", ("ns/g/000001/0001/0002", b"\x02"), {}),
    ("key_value_set_bytes", ("ns/g/000001/0000/0000", b"\x03"), {}),
    ("key_value_dir_get_bytes", ("ns/g/000001/0001/",), {}),
    ("key_value_dir_get_bytes", ("ns/g/000001/",), {}),
    ("key_value_try_get_bytes", ("ns/g/000001/0001/0002",), {}),
    ("key_value_delete", ("ns/g/000001/0001/0002",), {}),
    ("key_value_dir_get_bytes", ("ns/g/000001/0001/",), {}),
    ("key_value_delete", ("ns/g/000001/0001/0000",), {}),
    ("key_value_dir_get_bytes", ("ns/g/000001/0001/",), {}),
    ("key_value_set_bytes", ("ns/g/000001/0001/0001", b"\x04"), {}),
    ("key_value_dir_get_bytes", ("ns/g/000001/0001/",), {}),
    ("key_value_delete", ("ns/nothing",), {}),
    # the router's inbox: two levels under the directory read
    ("key_value_set_bytes", ("ns/m/0/000002/000000000000", b"a"), {}),
    ("key_value_set_bytes", ("ns/m/0/000001/000000000001", b"b"), {}),
    ("key_value_set_bytes", ("ns/m/0/000001/000000000000", b"c"), {}),
    ("key_value_dir_get_bytes", ("ns/m/0/",), {}),
    ("key_value_delete", ("ns/m/0/000001/000000000000",), {}),
    ("key_value_dir_get_bytes", ("ns/m/0/",), {}),
    ("key_value_dir_get_bytes", ("ns/m/1/",), {}),
    # membership and checksums: string directories
    ("key_value_set", ("ns/member/1", "worker"), {"allow_overwrite": True}),
    ("key_value_set", ("ns/member/0", "master"), {"allow_overwrite": True}),
    ("key_value_set", ("ns/member/1", "worker"), {"allow_overwrite": True}),
    ("key_value_dir_get", ("ns/member/",), {}),
    ("key_value_set", ("ns/chk/000003/0001", "77"), {"allow_overwrite": True}),
    ("key_value_dir_get", ("ns/chk/000003/",), {}),
    ("key_value_dir_get", ("ns/chk/000004/",), {}),
]


def test_store_kv_matches_the_fake_call_for_call(kv):
    fake = FakeKvClient()
    for name, args, kw in SCRIPT:
        want = _outcome(getattr(fake, name), *args, **kw)
        got = _outcome(getattr(kv, name), *args, **kw)
        assert got == want, (name, args, got, want)


@pytest.mark.parametrize("use_libuv,lanes", [(True, 1), (False, 1),
                                              (True, 3)])
def test_a_value_over_the_payload_cap_round_trips(use_libuv, lanes):
    """Whole, on either server, its parts on one connection or on three
    at once."""
    server = _server(use_libuv)
    kv = StoreKv(server, lanes=lanes)
    big = os.urandom(20 << 20)  # 20 MiB: five parts, over the 8 MiB cap
    kv.key_value_set_bytes("big/v", big)
    assert kv.key_value_try_get_bytes("big/v") == big
    assert kv.key_value_dir_get_bytes("big/") == [("big/v", big)]
    kv.key_value_set_bytes("big/v", big[::-1])  # an overwrite
    assert kv.key_value_try_get_bytes("big/v") == big[::-1]
    kv.key_value_delete("big/v")
    with pytest.raises(RuntimeError, match="NOT_FOUND"):
        kv.key_value_try_get_bytes("big/v")
    # the parts went with the key: only the directory index is left
    assert not [k for k in server.list_keys() if "/p/" in k] \
        if hasattr(server, "list_keys") else True


def test_a_reader_sees_a_value_whole_or_not_at_all(server):
    """A writer overwrites and deletes a parted value while a reader on
    its own connection reads it: every read is one of the written values
    or NOT_FOUND, never a mix of two generations' parts."""
    writer = StoreKv(server, root="whole/", part_bytes=1 << 16, lanes=2)
    reader = writer.clone()
    values = [bytes([i]) * (5 << 16) for i in range(4)]
    stop = threading.Event()
    seen, bad = set(), []

    def read():
        while not stop.is_set():
            try:
                v = reader.key_value_try_get_bytes("k")
            except RuntimeError as exc:
                assert "NOT_FOUND" in str(exc)
                seen.add("missing")
                continue
            if v not in values:
                bad.append(len(v))
            seen.add(bytes(v[:1]))

    t = threading.Thread(target=read, daemon=True)
    t.start()
    for i in range(60):
        writer.key_value_set_bytes("k", values[i % 4])
        if i % 5 == 4:
            writer.key_value_delete("k")
    stop.set()
    t.join(timeout=30)
    assert not bad
    assert len(seen) >= 2


def test_try_get_never_waits_on_a_missing_or_deleted_key(server):
    """A try-get of a missing key returns NOT_FOUND at once, and one
    racing the deletes of the trainer's own collection (a second
    connection deleting what the first reads) answers within its
    time too."""
    kv = StoreKv(server, root="race/", part_bytes=1 << 12)
    other = kv.clone()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="NOT_FOUND"):
        kv.key_value_try_get("never/set")
    assert time.monotonic() - t0 < 1.0
    keys = [f"g/{i:04d}" for i in range(200)]
    for k in keys:
        kv.key_value_set_bytes(k, b"x" * (3 << 12))

    def delete():
        for k in keys:
            other.key_value_delete(k)

    t = threading.Thread(target=delete)
    t.start()
    slowest = 0.0
    outcomes = set()
    for k in keys:
        t0 = time.monotonic()
        outcomes.add(_outcome(kv.key_value_try_get_bytes, k)[0])
        slowest = max(slowest, time.monotonic() - t0)
    t.join(timeout=30)
    assert slowest < 1.0
    assert outcomes <= {"ok", "err"}
    with pytest.raises(RuntimeError, match="NOT_FOUND"):
        kv.key_value_dir_get_bytes("g/")


def test_a_non_overwriting_set_keeps_the_value_and_its_parts(kv):
    kv.key_value_set_bytes("p/k", b"a" * (9 << 20))
    with pytest.raises(RuntimeError, match="ALREADY_EXISTS"):
        kv._set("p/k", b"b" * (9 << 20), allow_overwrite=False)
    assert kv.key_value_try_get_bytes("p/k") == b"a" * (9 << 20)


CHILD = """
import sys, time
from akka_allreduce_tpu_torch.messages import CompleteAllreduce
from akka_allreduce_tpu_torch.protocol.kv import KvRouter, StoreKv
port, n = int(sys.argv[1]), int(sys.argv[2])
got = []
router = KvRouter(rank=1, role="worker", namespace="fifo",
                  client=StoreKv.connect("127.0.0.1", port))
router.register("engine", got.append)
for r in range(n):
    router.send(router.ref_of(0), CompleteAllreduce(src_id=1, round=r))
deadline = time.monotonic() + 60
while not got and time.monotonic() < deadline:
    router.poll(0.05)
print("REPLY", got[0].round)
router.close()
"""


def test_router_across_two_processes_keeps_fifo_and_members(server):
    n = 25
    members, got = [], []
    router = KvRouter(rank=0, role="master", namespace="fifo",
                      client=StoreKv(server),
                      on_member=lambda ref, role: members.append(
                          (ref.rank, role)))
    router.register("engine", got.append)
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(server.port), str(n)], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while len(got) < n and time.monotonic() < deadline:
            router.poll(0.05)
        assert [m.round for m in got] == list(range(n))
        assert all(isinstance(m, CompleteAllreduce) and m.src_id == 1
                   for m in got)
        assert members == [(1, "worker")]
        assert isinstance(router.ref_of(1), KvRef)
        router.send(router.ref_of(1), CompleteAllreduce(src_id=0, round=99))
        out, err = child.communicate(timeout=60)
        assert child.returncode == 0, err
        assert "REPLY 99" in out
    finally:
        if child.poll() is None:
            child.kill()
        router.close()
