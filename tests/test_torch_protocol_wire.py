"""The port's wire codec against the JAX package's, frame by frame.

Every frame type 0-13 is built from the same numpy data in both packages
(the port's allreduce payloads as torch tensors): the port's ``encode``
must give JAX's bytes exactly, and each package's ``decode`` must read
the other's bytes back with the same fields and the payload bitwise.
Then the hostile-frame and seeded codec-fuzz cases of
``tests/test_wire_serving_frames.py`` on the port's codec: every
malformed frame raises one of the port's ``WireError`` subclasses. And
the payload's lifetime: a chunk encoded as a view of its source travels
as it was when it was encoded, whatever the source holds later.
"""

import struct

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import messages as jax_messages
from akka_allreduce_tpu.protocol import wire as jax_wire
from akka_allreduce_tpu_torch import messages as port_messages
from akka_allreduce_tpu_torch.protocol import wire
from akka_allreduce_tpu_torch.protocol.wire import (
    CancelFrame,
    CompletionFrame,
    DrainDoneFrame,
    DrainFrame,
    HealthFrame,
    ResumeFrame,
    SERVING_WIRE_VERSION,
    SubmitFrame,
    TruncatedFrame,
    WireError,
    WireVersionError,
    decode,
    encode,
)


class Ref:
    """A ref both codecs resolve through ``addr_of``."""

    def __init__(self, addr):
        self.addr = tuple(addr)


def addr_of(ref):
    return ref.addr


def payload(side, values: np.ndarray):
    return torch.from_numpy(values.copy()) if side == "port" else values


def build(mtype: int, side: str, seed: int = 0):
    """Frame ``mtype`` from seeded numpy data, as ``side``'s message."""
    rng = np.random.default_rng(seed + 100 * mtype)
    m = jax_messages if side == "jax" else port_messages
    w = jax_wire if side == "jax" else wire
    values = rng.standard_normal(int(rng.integers(1, 40))).astype(np.float32)
    toks = tuple(int(t) for t in rng.integers(0, 2 ** 31 - 1, size=5))
    if mtype == 0:
        return w.Hello(("127.0.0.1", int(rng.integers(1, 65535))), "worker")
    if mtype == 1:
        return m.InitWorkers(
            workers={0: Ref(("10.0.0.1", 2551)), 1: Ref(("10.0.0.2", 2552)),
                     3: Ref(("host-3", 7))},
            worker_num=4, master=Ref(("10.0.0.9", 2550)), dest_id=1,
            th_reduce=0.9, th_complete=0.8, max_lag=3, data_size=778,
            max_chunk_size=3, start_round=int(rng.integers(0, 99)))
    if mtype == 2:
        return m.StartAllreduce(int(rng.integers(0, 2 ** 40)))
    if mtype == 3:
        return m.ScatterBlock(payload(side, values), 1, 2, 3,
                              int(rng.integers(0, 99)))
    if mtype == 4:
        return m.ReduceBlock(payload(side, values), 0, 4, 2,
                             int(rng.integers(0, 99)), count=3)
    if mtype == 5:
        return m.CompleteAllreduce(5, int(rng.integers(0, 99)))
    if mtype == 6:
        return w.Ping(float(rng.random()))
    if mtype == 7:
        return w.SubmitFrame(rid=7, prompt=toks, max_new_tokens=5,
                             eos_token=2, stop_tokens=(4, 9), deadline=1.5,
                             attempts=2, seed=11)
    if mtype == 8:
        return w.CompletionFrame(3, toks, "eos", replica=5, waste=4)
    if mtype == 9:
        return w.HealthFrame(replica=1, occupied=2, free_slots=0,
                             dispatches=55, compiles=7, draining=True,
                             watchdog_trips=2, evictions=3,
                             prefill_programs=4, cancelled_tokens=9,
                             checkpoint_version=12)
    if mtype == 10:
        return w.DrainFrame()
    if mtype == 11:
        return w.ResumeFrame(rid=4, prompt=toks, max_new_tokens=8,
                             generated=(5, 6, 7), eos_token=3,
                             stop_tokens=(9,), deadline=0.25, attempts=1,
                             seed=13, replica=0)
    if mtype == 12:
        return w.DrainDoneFrame(1, 3)
    assert mtype == 13
    return w.CancelFrame(int(rng.integers(0, 2 ** 62)))


def fields(msg) -> dict:
    """A decoded message as plain values: refs as addresses, payloads as
    little-endian f32 bytes."""
    slots = getattr(type(msg), "__slots__", None)
    if hasattr(msg, "__dataclass_fields__"):
        names = list(msg.__dataclass_fields__)
    elif slots is not None:
        names = list(slots)
    else:
        names = list(vars(msg))
    out = {"type": type(msg).__name__}
    for name in names:
        v = getattr(msg, name)
        if name == "value":
            v = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                           dtype="<f4").tobytes()
        elif name == "workers":
            v = {r: ref.addr for r, ref in v.items()}
        elif name == "master":
            v = v.addr
        out[name] = v
    return out


@pytest.mark.parametrize("mtype", range(14))
def test_encode_bytes_equal_jax(mtype):
    assert encode(build(mtype, "port"), addr_of) == \
        jax_wire.encode(build(mtype, "jax"), addr_of)


@pytest.mark.parametrize("mtype", range(14))
def test_each_package_decodes_the_others_bytes(mtype):
    jax_bytes = jax_wire.encode(build(mtype, "jax"), addr_of)
    port_bytes = encode(build(mtype, "port"), addr_of)
    by_port = decode(jax_bytes, Ref)
    by_jax = jax_wire.decode(port_bytes, Ref)
    assert fields(by_port) == fields(by_jax) \
        == fields(jax_wire.decode(jax_bytes, Ref))
    if mtype in (3, 4):
        # the port hands its engine a CPU f32 tensor that owns its bytes
        assert isinstance(by_port.value, torch.Tensor)
        assert by_port.value.dtype == torch.float32
        assert by_port.value.device.type == "cpu"
        assert by_port.value.is_contiguous()


def test_payload_is_encoded_once_as_little_endian_f32():
    """A non-f32 or strided payload crosses as f32 bytes: the same bytes
    JAX's ``np.asarray(value, float32).tobytes()`` gives."""
    base = np.arange(12, dtype=np.float64)
    strided = torch.from_numpy(base)[::3]
    got = encode(port_messages.ScatterBlock(strided, 0, 1, 0, 0), addr_of)
    want = jax_wire.encode(jax_messages.ScatterBlock(base[::3], 0, 1, 0, 0),
                           addr_of)
    assert got == want


def test_chunk_view_encoded_then_source_overwritten():
    """A chunk is a view of the worker's copy of the round's input; its
    bytes are taken at encode time, so a later write to the source (a
    refilled source, the next round) cannot change the sent frame."""
    data = torch.arange(12, dtype=torch.float32)
    msg = port_messages.ScatterBlock(data[3:6], 0, 1, 1, 0)
    buf = encode(msg, addr_of)
    data.fill_(-7.0)
    assert msg.value.tolist() == [-7.0] * 3  # the view sees the write
    assert decode(buf, Ref).value.tolist() == [3.0, 4.0, 5.0]


def test_decoded_payload_owns_its_bytes():
    buf = bytearray(encode(port_messages.ReduceBlock(
        torch.ones(4), 0, 1, 0, 0, count=2), addr_of))
    value = decode(buf, Ref).value
    buf[-4:] = struct.pack("<f", 9.0)
    assert value.tolist() == [1.0] * 4


# -- tests/test_wire_serving_frames.py on the port's codec --------------------

def roundtrip(frame):
    return decode(encode(frame, None), None)


class TestRoundTrips:
    def test_submit(self):
        f = SubmitFrame(rid=7, prompt=(1, 2, 3), max_new_tokens=5,
                        eos_token=2, stop_tokens=(4, 9),
                        deadline=1.5, attempts=2, seed=11)
        assert roundtrip(f) == f

    def test_completion_carries_replica_and_waste(self):
        back = roundtrip(CompletionFrame(9, (), "cancelled", replica=2,
                                         waste=17))
        assert (back.replica, back.waste) == (2, 17)
        assert roundtrip(CompletionFrame(4, (), "watchdog")).replica == -1
        with pytest.raises(ValueError, match="waste"):
            CompletionFrame(9, (), "cancelled", waste=-1)

    def test_resume_optionals_none(self):
        back = roundtrip(ResumeFrame(rid=4, prompt=(1,), max_new_tokens=8))
        assert back.eos_token is None and back.deadline is None
        assert back.seed is None and back.generated == ()

    def test_request_frame_mapping(self):
        from akka_allreduce_tpu_torch.serving.scheduler import Request
        req = Request(rid=9, prompt=(3, 1, 4), max_new_tokens=6,
                      eos_token=2, stop_tokens=(5,), deadline=2.5,
                      attempts=1, seed=77, arrival=8.0)
        back = wire.frame_to_request(roundtrip(wire.request_to_frame(req)))
        assert isinstance(back, Request)
        assert (back.rid, back.prompt, back.max_new_tokens, back.eos_token,
                back.stop_tokens, back.deadline, back.attempts,
                back.seed) == (9, (3, 1, 4), 6, 2, (5,), 2.5, 1, 77)
        assert back.arrival == 0.0  # the router's clock does not travel


class TestVersioning:
    @pytest.mark.parametrize("mtype", range(7, 14))
    def test_every_serving_frame_carries_the_version_byte(self, mtype):
        assert encode(build(mtype, "port"), None)[1] == SERVING_WIRE_VERSION

    def test_version_mismatch_is_a_clear_error(self):
        buf = bytearray(encode(CompletionFrame(1, (2,), "eos"), None))
        buf[1] = SERVING_WIRE_VERSION + 1
        with pytest.raises(WireVersionError, match="different builds"):
            decode(bytes(buf), None)

    def test_allreduce_frames_stay_unversioned(self):
        back = decode(encode(wire.Ping(2.0), None), None)
        assert isinstance(back, wire.Ping) and back.interval == 2.0


class TestHostileFrames:
    def test_truncated_submit_header(self):
        buf = encode(SubmitFrame(rid=0, prompt=(5,), max_new_tokens=1), None)
        with pytest.raises(TruncatedFrame, match="truncated"):
            decode(buf[:6], None)

    def test_lying_payload_counts(self):
        buf = bytearray(encode(SubmitFrame(rid=0, prompt=(5,),
                                           max_new_tokens=1), None))
        struct.pack_into("<I", buf, 2 + struct.calcsize("<qIiBiBd"), 1000)
        with pytest.raises(TruncatedFrame):
            decode(bytes(buf), None)

    def test_lying_completion_counts(self):
        buf = bytearray(encode(CompletionFrame(1, (2, 3), "eos"), None))
        struct.pack_into("<I", buf, 2 + struct.calcsize("<qiIB"), 1 << 20)
        with pytest.raises(TruncatedFrame):
            decode(bytes(buf), None)

    def test_lying_payload_bytes_of_a_scatter_block(self):
        buf = bytearray(encode(port_messages.ScatterBlock(
            torch.ones(3), 0, 1, 0, 0), addr_of))
        struct.pack_into("<Q", buf, 1 + struct.calcsize("<iiiq"), 1 << 40)
        with pytest.raises(WireError):
            decode(bytes(buf), Ref)

    def test_unknown_type_is_wire_error(self):
        with pytest.raises(WireError, match="unknown message type"):
            decode(bytes([250]), None)

    def test_empty_frame(self):
        with pytest.raises(TruncatedFrame):
            decode(b"", None)


def _fuzz_frames(rng):
    """One randomized instance of every serving frame type (the JAX
    suite's generator)."""
    def toks(n):
        return tuple(int(x) for x in rng.integers(0, 2**31 - 1, size=n))
    return [
        SubmitFrame(
            rid=int(rng.integers(0, 2**62)),
            prompt=toks(int(rng.integers(1, 33))),
            max_new_tokens=int(rng.integers(1, 512)),
            eos_token=(None if rng.random() < 0.5
                       else int(rng.integers(0, 1000))),
            stop_tokens=toks(int(rng.integers(0, 5))),
            deadline=(None if rng.random() < 0.5
                      else float(rng.random() * 100)),
            attempts=int(rng.integers(0, 5)),
            seed=(None if rng.random() < 0.5
                  else int(rng.integers(0, 2**31)))),
        CompletionFrame(
            rid=int(rng.integers(0, 2**62)),
            tokens=toks(int(rng.integers(0, 64))),
            reason=str(rng.choice(["eos", "stop", "max_tokens",
                                   "cancelled", "fault"])),
            replica=int(rng.integers(-1, 8)),
            waste=int(rng.integers(0, 100))),
        HealthFrame(
            replica=int(rng.integers(0, 8)),
            occupied=int(rng.integers(0, 16)),
            free_slots=int(rng.integers(0, 16)),
            dispatches=int(rng.integers(0, 2**40)),
            compiles=int(rng.integers(0, 1000)),
            draining=bool(rng.random() < 0.5),
            watchdog_trips=int(rng.integers(0, 10)),
            evictions=int(rng.integers(0, 10)),
            prefill_programs=int(rng.integers(0, 50)),
            cancelled_tokens=int(rng.integers(0, 2**40))),
        DrainFrame(),
        CancelFrame(rid=int(rng.integers(0, 2**62))),
        ResumeFrame(
            rid=int(rng.integers(0, 2**62)),
            prompt=toks(int(rng.integers(1, 33))),
            max_new_tokens=int(rng.integers(1, 512)),
            generated=toks(int(rng.integers(0, 32))),
            eos_token=(None if rng.random() < 0.5
                       else int(rng.integers(0, 1000))),
            stop_tokens=toks(int(rng.integers(0, 5))),
            deadline=(None if rng.random() < 0.5
                      else float(rng.random() * 100)),
            attempts=int(rng.integers(0, 5)),
            seed=(None if rng.random() < 0.5
                  else int(rng.integers(0, 2**31))),
            replica=int(rng.integers(-1, 8))),
        DrainDoneFrame(replica=int(rng.integers(0, 8)),
                       migrated=int(rng.integers(0, 64))),
    ]


FUZZ_SEEDS = (0, 1, 2, 3, 4, 5)


class TestCodecFuzz:
    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_roundtrip_byte_exact_and_jax_bytes(self, seed):
        rng = np.random.default_rng(seed)
        for frame in _fuzz_frames(rng):
            # the same frame built with the JAX class
            jax_frame = getattr(jax_wire, type(frame).__name__)(**{
                s: getattr(frame, s) for s in type(frame).__slots__})
            buf = encode(frame, None)
            assert buf == jax_wire.encode(jax_frame, None)
            back = decode(buf, None)
            assert back == frame, frame
            assert encode(back, None) == buf

    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_every_truncation_raises_truncated(self, seed):
        rng = np.random.default_rng(seed)
        for frame in _fuzz_frames(rng):
            buf = encode(frame, None)
            for cut in range(len(buf)):
                with pytest.raises(TruncatedFrame):
                    decode(buf[:cut], None)

    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_bit_flips_never_escape_raw(self, seed):
        rng = np.random.default_rng(seed)
        for frame in _fuzz_frames(rng):
            buf = bytearray(encode(frame, None))
            for _ in range(min(4 * len(buf), 256)):
                pos = int(rng.integers(0, len(buf)))
                mut = bytearray(buf)
                mut[pos] ^= 1 << int(rng.integers(0, 8))
                try:
                    decode(bytes(mut), None)  # a legal mutation is fine
                except WireError:
                    pass

    @pytest.mark.parametrize("seed", FUZZ_SEEDS)
    def test_lying_length_fields_raise_wire_errors(self, seed):
        rng = np.random.default_rng(seed)
        for frame in _fuzz_frames(rng):
            buf = bytearray(encode(frame, None))
            for pos in range(len(buf)):
                mut = bytearray(buf)
                mut[pos] = 0xFF
                try:
                    decode(bytes(mut), None)
                except WireError:
                    pass

    @pytest.mark.parametrize("mtype", range(7))
    def test_allreduce_frame_truncations_raise_wire_errors(self, mtype):
        buf = encode(build(mtype, "port"), addr_of)
        for cut in range(len(buf)):
            try:
                decode(buf[:cut], Ref)
            except WireError:
                pass
