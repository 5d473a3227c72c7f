"""The port's wire format: codec properties, framing, the front door, and
byte-for-byte agreement with the JAX package's codec.

Ports tests/test_wire_props.py (round trip over every message type,
totality over garbage and bit-flipped frames, version/overrun/unknown-type
rejection, the untrusted allow-list, TCP framing, a hostile producer at the
front door) and the codec tests of tests/test_federation.py onto
`repro_torch.twin.wire`.  Beyond those: for every registered message type,
the same fields encode to IDENTICAL bytes in both packages, and each
package decodes the other's frames -- a JAX coordinator can talk to a port
worker and back.  No tolerance anywhere: the codec moves raw bytes.
"""
import dataclasses
import socket
import struct

import numpy as np
import pytest

import repro.twin.wire as JW
import repro_torch.twin.wire as W
from repro_torch.twin.wire import (WIRE_VERSION, FrontDoorClient,
                                   IngestFrontDoor, WireError, decode, encode,
                                   read_frame, write_frame)

SEED = 20260807
_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]


def _rand_array(rng, *, max_rank=3, max_dim=6):
    dt = _DTYPES[rng.integers(len(_DTYPES))]
    shape = tuple(int(rng.integers(0, max_dim + 1))
                  for _ in range(int(rng.integers(0, max_rank + 1))))
    if np.issubdtype(dt, np.floating):
        a = rng.standard_normal(shape).astype(dt)
    elif dt is np.bool_:
        a = rng.integers(0, 2, shape).astype(bool)
    else:
        a = rng.integers(-1000, 1000, shape).astype(dt)
    return a


def _builders(rng, W=W):
    """One builder per registered message type, in registry order."""
    return [
        lambda: W.Hello(shard=int(rng.integers(0, 64)),
                        tick=int(rng.integers(0, 1 << 20)),
                        ckpt_tick=(None if rng.random() < 0.3
                                   else int(rng.integers(0, 1 << 20))),
                        samples={str(int(rng.integers(0, 99))):
                                 int(rng.integers(0, 1 << 16))
                                 for _ in range(int(rng.integers(0, 4)))}),
        lambda: W.IngestBatch(
            twin_ids=rng.integers(0, 1 << 20, int(rng.integers(0, 5)))
            .astype(np.int64),
            counts=rng.integers(0, 64, int(rng.integers(0, 5)))
            .astype(np.int32),
            y=rng.standard_normal((int(rng.integers(0, 9)),
                                   int(rng.integers(1, 5))))
            .astype(np.float32),
            u=(None if rng.random() < 0.5 else
               rng.standard_normal((int(rng.integers(0, 9)), 1))
               .astype(np.float32)),
            force=bool(rng.integers(0, 2))),
        lambda: W.TickCmd(tick=int(rng.integers(0, 1 << 30)),
                          grant=int(rng.integers(-1, 16)),
                          inject_delay_s=float(rng.random())),
        lambda: W.TickDone(tick=int(rng.integers(0, 1 << 30)),
                           latency_s=float(rng.random()),
                           deadline_met=bool(rng.integers(0, 2)),
                           n_active=int(rng.integers(0, 64)),
                           n_twins=int(rng.integers(0, 1 << 16)),
                           n_guarded=int(rng.integers(0, 64)),
                           degraded_level=int(rng.integers(0, 4)),
                           pressure=float(rng.random()),
                           loss=(None if rng.random() < 0.5
                                 else float(rng.random())),
                           events=[[int(rng.integers(0, 99)), "diverged",
                                    float(rng.random()),
                                    int(rng.integers(0, 99)),
                                    float(rng.random())]
                                   for _ in range(int(rng.integers(0, 3)))]),
        lambda: W.Deploy(twin_ids=rng.integers(0, 99, 3).astype(np.int64),
                         thetas=_rand_array(rng)),
        lambda: W.PredictCmd(twin_id=int(rng.integers(0, 99)),
                             horizon=int(rng.integers(1, 64)),
                             us=(None if rng.random() < 0.5
                                 else _rand_array(rng))),
        lambda: W.PredictResult(ys=_rand_array(rng)),
        lambda: W.Scenario(twin_id=int(rng.integers(0, 99)),
                           horizon=int(rng.integers(1, 64)),
                           k=(None if rng.random() < 0.5
                              else int(rng.integers(1, 9))),
                           us=(None if rng.random() < 0.5
                               else rng.standard_normal((2, 4, 1))
                               .astype(np.float32))),
        lambda: W.ScenarioResult(
            twin_id=int(rng.integers(0, 99)),
            horizon=int(rng.integers(1, 64)),
            requested_k=int(rng.integers(1, 9)),
            k=int(rng.integers(1, 9)),
            degraded_level=int(rng.integers(0, 4)),
            ys=rng.standard_normal((2, 5, 3)).astype(np.float32),
            lo=rng.standard_normal((2, 5, 3)).astype(np.float32),
            hi=rng.standard_normal((2, 5, 3)).astype(np.float32),
            confidence=rng.random(2).astype(np.float32)),
        lambda: W.DrainCmd(),
        lambda: W.Ack(n=int(rng.integers(0, 1 << 20))),
        lambda: W.StatsCmd(kind=["latency", "stage", "reset"]
                           [rng.integers(3)]),
        lambda: W.Stats(data={"p50_ms": float(rng.random())}),
        lambda: W.SnapshotCmd(),
        lambda: W.SnapshotBlob.pack({"tick": int(rng.integers(0, 99)),
                                     "arr": _rand_array(rng)}),
        lambda: W.Shutdown(),
        lambda: W.ErrorMsg(where="tick", error="boom"),
    ]


def _rand_msg(rng, W=W):
    """One random instance of a random registered message type."""
    builders = _builders(rng, W)
    return builders[rng.integers(len(builders))]()


def _assert_same(a, b):
    assert type(a) is type(b)
    import dataclasses
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape
            np.testing.assert_array_equal(va, vb)
        elif va is None or vb is None:
            assert va is vb
        else:
            assert va == vb


# --------------------------------------------------------------------- #
# property 1: round trip
# --------------------------------------------------------------------- #
def test_roundtrip_fuzz_all_message_types():
    rng = np.random.default_rng(SEED)
    seen = set()
    for _ in range(400):
        msg = _rand_msg(rng)
        seen.add(type(msg).TYPE)
        out = decode(encode(msg))
        if isinstance(msg, W.SnapshotBlob):
            a, b = msg.unpack(), out.unpack()
            assert a["tick"] == b["tick"]
            np.testing.assert_array_equal(a["arr"], b["arr"])
        else:
            _assert_same(msg, out)
    # the fuzzer must actually cover the registry (new messages included)
    assert seen == set(W._REGISTRY), f"uncovered types: {set(W._REGISTRY) - seen}"


def test_roundtrip_preserves_noncontiguous_and_views():
    base = np.arange(48, dtype=np.float32).reshape(6, 8)
    msg = W.PredictResult(ys=base[::2, ::2])      # strided view
    out = decode(encode(msg))
    np.testing.assert_array_equal(out.ys, base[::2, ::2])
    assert out.ys.flags["C_CONTIGUOUS"]


def test_ingest_chunks_roundtrip():
    rng = np.random.default_rng(SEED + 1)
    batch = [(int(i), rng.standard_normal((4, 2)).astype(np.float32),
              rng.standard_normal((4, 1)).astype(np.float32))
             for i in range(5)]
    msg = decode(encode(W.IngestBatch.from_chunks(batch)))
    for (tid, y, u), (tid2, y2, u2) in zip(batch, msg.chunks()):
        assert tid == tid2
        np.testing.assert_array_equal(y, y2)
        np.testing.assert_array_equal(u, u2)
    assert msg.n_samples == 20


# --------------------------------------------------------------------- #
# property 2: totality over garbage
# --------------------------------------------------------------------- #
def test_decode_garbage_raises_wireerror_only():
    rng = np.random.default_rng(SEED + 2)
    for _ in range(300):
        n = int(rng.integers(0, 200))
        payload = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        try:
            decode(payload)
        except WireError:
            pass                                   # the only allowed failure


def test_decode_mutated_valid_frames_never_crash():
    """Bit-flipped REAL frames: decode returns a message or WireError —
    never IndexError/KeyError/json errors/segfault-shaped surprises."""
    rng = np.random.default_rng(SEED + 3)
    for _ in range(300):
        buf = bytearray(encode(_rand_msg(rng)))
        for _ in range(int(rng.integers(1, 4))):
            buf[rng.integers(len(buf))] = int(rng.integers(0, 256))
        try:
            decode(bytes(buf))
        except WireError:
            pass


def test_decode_rejects_wrong_version():
    buf = bytearray(encode(W.Ack(n=1)))
    struct.pack_into(">H", buf, 0, WIRE_VERSION + 1)
    with pytest.raises(WireError, match="wire version"):
        decode(bytes(buf))


def test_decode_rejects_overrunning_header_and_blob():
    buf = bytearray(encode(W.Ack(n=1)))
    struct.pack_into(">I", buf, 2, 1 << 20)        # header_len overrun
    with pytest.raises(WireError, match="overruns"):
        decode(bytes(buf))
    frame = encode(W.PredictResult(ys=np.ones((4, 4), np.float32)))
    with pytest.raises(WireError, match="overruns"):
        decode(frame[:-8])                          # truncated blob


def test_decode_rejects_unknown_type_and_bad_fields():
    hdr = b'{"t":"no_such_message"}'
    frame = struct.pack(">HI", WIRE_VERSION, len(hdr)) + hdr
    with pytest.raises(WireError, match="bad header"):
        decode(frame)
    hdr = b'{"t":"ack","bogus_field":1}'
    frame = struct.pack(">HI", WIRE_VERSION, len(hdr)) + hdr
    with pytest.raises(WireError, match="bad fields"):
        decode(frame)


def test_untrusted_decode_enforces_allowlist():
    for msg, ok in [(W.IngestBatch.from_chunks([(0, np.ones((2, 2)))]), True),
                    (W.Ack(n=1), True),
                    (W.ErrorMsg(error="x"), True),
                    (W.Scenario(twin_id=0, horizon=4), False),
                    (W.Deploy(twin_ids=np.zeros(1, np.int64),
                              thetas=np.ones((1, 2, 3))), False),
                    (W.SnapshotBlob.pack({"x": 1}), False),
                    (W.Shutdown(), False)]:
        if ok:
            decode(encode(msg), trusted=False)
        else:
            with pytest.raises(WireError, match="untrusted"):
                decode(encode(msg), trusted=False)


# --------------------------------------------------------------------- #
# stream framing + front door under hostile bytes
# --------------------------------------------------------------------- #
def _sock_pair():
    a, b = socket.socketpair()
    return a, b


def test_read_frame_rejects_oversized_length():
    a, b = _sock_pair()
    try:
        a.sendall(struct.pack(">I", W._MAX_FRAME + 1))
        with pytest.raises(WireError, match="exceeds"):
            read_frame(b)
    finally:
        a.close(), b.close()


def test_read_frame_eof_semantics():
    a, b = _sock_pair()
    try:
        a.close()
        assert read_frame(b) is None               # clean EOF
    finally:
        b.close()
    a, b = _sock_pair()
    try:
        a.sendall(struct.pack(">I", 100) + b"short")
        a.close()
        with pytest.raises(WireError, match="EOF mid-frame"):
            read_frame(b)
    finally:
        b.close()


def test_write_read_frame_roundtrip_fuzz():
    rng = np.random.default_rng(SEED + 4)
    a, b = _sock_pair()
    try:
        for _ in range(50):
            payload = rng.integers(0, 256, int(rng.integers(0, 4096))) \
                .astype(np.uint8).tobytes()
            write_frame(a, payload)
            assert read_frame(b) == payload
    finally:
        a.close(), b.close()


def test_front_door_survives_hostile_producer():
    """Garbage frames, forbidden types, then a valid batch — the door must
    answer ErrorMsg / ErrorMsg / Ack on the SAME connection, and the sink
    must see only the valid chunks."""
    staged = []

    def sink(chunks, *, force=False):
        staged.extend(chunks)
        return sum(c[1].shape[0] for c in chunks)

    door = IngestFrontDoor(sink)
    rng = np.random.default_rng(SEED + 5)
    try:
        raw = socket.create_connection(door.address)
        try:
            # 1) random garbage payload
            write_frame(raw, rng.integers(0, 256, 64).astype(np.uint8)
                        .tobytes())
            reply = decode(read_frame(raw), trusted=False)
            assert isinstance(reply, W.ErrorMsg)
            # 2) well-formed but forbidden type
            write_frame(raw, encode(W.Shutdown()))
            reply = decode(read_frame(raw), trusted=False)
            assert isinstance(reply, W.ErrorMsg)
            # 3) valid batch still lands
            write_frame(raw, encode(W.IngestBatch.from_chunks(
                [(7, np.ones((3, 2), np.float32))])))
            reply = decode(read_frame(raw), trusted=False)
            assert isinstance(reply, W.Ack) and reply.n == 3
        finally:
            raw.close()
        assert len(staged) == 1 and staged[0][0] == 7
        # the client helper sees the same contract
        cl = FrontDoorClient(door.address)
        try:
            assert cl.ingest(8, np.ones((2, 2), np.float32)) == 2
        finally:
            cl.close()
    finally:
        door.close()


# --------------------------------------------------------------------- #
# hypothesis variants (shrinking search) — import-gated: the environment
# without the plugin still runs everything above
# --------------------------------------------------------------------- #
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:

    @pytest.mark.hypothesis
    @settings(max_examples=200, deadline=None)
    @given(st.binary(max_size=256))
    def test_hyp_decode_total(payload):
        try:
            decode(payload)
        except WireError:
            pass

    @pytest.mark.hypothesis
    @settings(max_examples=100, deadline=None)
    @given(st.integers(0, 1 << 30), st.integers(-1, 64),
           st.floats(0, 10, allow_nan=False))
    def test_hyp_tickcmd_roundtrip(tick, grant, delay):
        msg = W.TickCmd(tick=tick, grant=grant, inject_delay_s=delay)
        _assert_same(msg, decode(encode(msg)))


# --------------------------------------------------------------------- #
# the codec tests of tests/test_federation.py
# --------------------------------------------------------------------- #
def _chunks(with_u: bool = True):
    rng = np.random.default_rng(0)
    return [(tid,
             rng.standard_normal((3, 2)).astype(np.float32),
             rng.standard_normal((3, 1)).astype(np.float32) if with_u
             else None)
            for tid in (4, 9, 4)]


@pytest.mark.parametrize("with_u", [True, False])
def test_ingest_batch_roundtrip(with_u):
    batch = _chunks(with_u)
    msg = W.decode(W.encode(W.IngestBatch.from_chunks(batch, force=True)))
    assert isinstance(msg, W.IngestBatch) and msg.force
    assert msg.n_samples == 9
    out = list(msg.chunks())
    assert [c[0] for c in out] == [c[0] for c in batch]
    for (_, y, u), (_, y0, u0) in zip(out, batch):
        np.testing.assert_array_equal(y, y0)
        if with_u:
            np.testing.assert_array_equal(u, u0)
        else:
            assert u is None


def test_tick_done_roundtrip():
    done = W.TickDone(tick=7, latency_s=0.25, deadline_met=True, n_active=3,
                      n_twins=5, n_guarded=2, degraded_level=1, pressure=0.5,
                      loss=0.125, ckpt_tick=4,
                      events=[[3, "ALERT", 2.5, 7]])
    out = W.decode(W.encode(done))
    assert out.tick == 7 and out.ckpt_tick == 4 and out.loss == 0.125
    assert out.events == [[3, "ALERT", 2.5, 7]]


def test_hello_sample_keys_stringify_over_json():
    """JSON stringifies int dict keys -- the coordinator converts back when
    computing the replay suffix; the codec itself must not hide it."""
    out = W.decode(W.encode(W.Hello(shard=1, tick=3, ckpt_tick=2,
                                    samples={5: 10})))
    assert out.samples == {"5": 10}
    assert {int(k): int(v) for k, v in out.samples.items()} == {5: 10}


def test_decode_rejects_foreign_version():
    payload = bytearray(W.encode(W.Ack(n=1)))
    payload[:2] = struct.pack(">H", W.WIRE_VERSION + 1)
    with pytest.raises(W.WireError, match="version"):
        W.decode(bytes(payload))


def test_untrusted_decode_admits_only_ingest():
    blob = W.encode(W.SnapshotBlob.pack({"theta": np.zeros(3)}))
    with pytest.raises(W.WireError):
        W.decode(blob, trusted=False)
    ok = W.decode(W.encode(W.IngestBatch.from_chunks(_chunks())),
                  trusted=False)
    assert isinstance(ok, W.IngestBatch)


def test_stream_framing_eof():
    a, b = socket.socketpair()
    try:
        payload = W.encode(W.DrainCmd())
        W.write_frame(a, payload)
        a.close()
        assert W.read_frame(b) == payload
        assert W.read_frame(b) is None     # clean EOF, not an exception
    finally:
        b.close()


# --------------------------------------------------------------------- #
# the two packages speak one wire format
# --------------------------------------------------------------------- #
_TYPES = list(W._REGISTRY)


def _pair(tag: str, seed: int):
    """The same message, built field for field with each package's
    classes from one seed."""
    k = _TYPES.index(tag)
    msgs = []
    for mod in (JW, W):
        rng = np.random.default_rng(seed)
        msgs.append(_builders(rng, mod)[k]())
    return msgs


def _same_fields(a, b):
    """Field-wise equality across packages (the classes differ)."""
    assert type(a).TYPE == type(b).TYPE
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    if type(a).TYPE == "snapshot_blob":
        assert a.payload.tobytes() == b.payload.tobytes()
        return
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb


def test_registries_match():
    assert W.WIRE_VERSION == JW.WIRE_VERSION
    assert list(W._REGISTRY) == list(JW._REGISTRY)
    assert W._UNTRUSTED_OK == JW._UNTRUSTED_OK
    assert W._MAX_FRAME == JW._MAX_FRAME
    for tag, cls in W._REGISTRY.items():
        jcls = JW._REGISTRY[tag]
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(jcls)]
        assert getattr(cls, "_ARRAY_FIELDS", ()) == \
            getattr(jcls, "_ARRAY_FIELDS", ())


@pytest.mark.parametrize("tag", _TYPES)
def test_frames_identical_across_packages(tag):
    """Same fields -> the same bytes from both encoders, and each decoder
    reads the other's frame back to the same fields."""
    for seed in range(SEED, SEED + 8):
        jmsg, tmsg = _pair(tag, seed)
        jframe, tframe = JW.encode(jmsg), W.encode(tmsg)
        assert jframe == tframe, f"{tag} seed {seed}"
        _same_fields(W.decode(jframe), tmsg)
        _same_fields(JW.decode(tframe), jmsg)


def test_stream_frames_cross_packages():
    """The TCP framing too: a frame written by one package reads back in
    the other, and the untrusted rule holds on both sides."""
    a, b = socket.socketpair()
    try:
        msg = W.IngestBatch.from_chunks(_chunks())
        W.write_frame(a, W.encode(msg))
        got = JW.decode(JW.read_frame(b), trusted=False)
        assert isinstance(got, JW.IngestBatch) and got.n_samples == 9
        JW.write_frame(b, JW.encode(JW.SnapshotBlob.pack({"x": 1})))
        with pytest.raises(W.WireError, match="untrusted"):
            W.decode(W.read_frame(a), trusted=False)
    finally:
        a.close()
        b.close()
