"""Versioned wire format for the federation split (twin/federation.py).

Everything the `FederationCoordinator` and its `ShardWorker` subprocesses —
or a telemetry producer and the ingestion front door — say to each other is
one of the message dataclasses below, encoded as:

    u16 WIRE_VERSION | u32 header_len | JSON header | raw array blobs

The JSON header carries the message type, every scalar field, and a
manifest (name, dtype, shape) for each array field; the blobs follow in
manifest order as raw C-contiguous bytes, so telemetry arrays cross the
process boundary without a JSON detour.  A version bump is the upgrade
gate: decode refuses frames whose major version it does not speak, which
is what lets coordinator and workers be restarted independently.

Transports share the codec, they differ only in framing:

  * `multiprocessing.Connection` — `send_bytes(encode(msg))` /
    `decode(recv_bytes())`; the pipe frames for us.
  * TCP stream — `write_frame`/`read_frame` add a u32 big-endian length
    prefix.  `IngestFrontDoor` (the network ingestion door) and
    `FrontDoorClient` (what a telemetry producer embeds) live here too.

TRUST BOUNDARY: the front door accepts ONLY `IngestBatch` (pure arrays).
`SnapshotBlob` carries a pickled tree and is valid ONLY on the
coordinator<->worker pipes, which never leave the machine; `decode`
enforces this with the `trusted` flag.

The codec is numpy only and its layout is the JAX package's, byte for byte
(same `WIRE_VERSION`, header, blob order, framing and trust rule), so a
frame from either package decodes in the other.  Tensors are converted at
the worker's edge (twin/federation.py), never here: a worker sends host
arrays, and packs its snapshot as a host tree
(`train/checkpoint.to_host`), so the coordinator never touches a device.
"""
from __future__ import annotations

import json
import pickle
import socket
import struct
import threading
from dataclasses import dataclass, field, fields

import numpy as np

__all__ = [
    "WIRE_VERSION", "WireError", "encode", "decode",
    "read_frame", "write_frame",
    "Hello", "IngestBatch", "TickCmd", "TickDone", "Deploy",
    "PredictCmd", "PredictResult", "Scenario", "ScenarioResult",
    "DrainCmd", "Ack", "StatsCmd", "Stats",
    "SnapshotCmd", "SnapshotBlob", "Shutdown", "ErrorMsg",
    "IngestFrontDoor", "FrontDoorClient",
]

WIRE_VERSION = 1          # bump MAJOR on any incompatible layout change
_MAX_FRAME = 1 << 28      # 256 MiB: corrupt length prefixes fail loudly
_HDR = struct.Struct(">HI")       # version, header_len
_LEN = struct.Struct(">I")        # stream length prefix


class WireError(RuntimeError):
    """Malformed, oversized, wrong-version, or untrusted frame."""


# --------------------------------------------------------------------------- #
# message registry
# --------------------------------------------------------------------------- #
_REGISTRY: dict[str, type] = {}


def _message(cls):
    """Register a message dataclass under its TYPE tag."""
    _REGISTRY[cls.TYPE] = cls
    return cls


@_message
@dataclass
class Hello:
    """Worker -> coordinator on (re)boot: what the worker already holds, so
    the supervisor can replay exactly the journal suffix after a restart
    (`samples[twin_id]` = samples the restored checkpoint had seen)."""
    TYPE = "hello"
    shard: int
    tick: int = 0                      # worker's restored tick counter
    ckpt_tick: int | None = None       # checkpoint tick it restored from
    samples: dict = field(default_factory=dict)   # twin_id(str) -> count


@_message
@dataclass
class IngestBatch:
    """A flush of telemetry chunks, columnar: `y[sum(counts), n]` holds the
    chunks back to back, `counts[i]` samples belonging to `twin_ids[i]`.
    The ONLY message the network front door accepts."""
    TYPE = "ingest"
    _ARRAY_FIELDS = ("twin_ids", "counts", "y", "u")
    twin_ids: np.ndarray               # int64 [k]
    counts: np.ndarray                 # int32 [k]
    y: np.ndarray                      # float32 [total, n]
    u: np.ndarray | None = None        # float32 [total, m] (None: no inputs)
    force: bool = False                # bypass staging backpressure (replay)

    @staticmethod
    def from_chunks(batch, *, force: bool = False) -> "IngestBatch":
        """Pack (twin_id, y[, u]) chunks into one columnar batch."""
        tids, counts, ys, us = [], [], [], []
        for chunk in batch:
            tid, y = chunk[0], chunk[1]
            u = chunk[2] if len(chunk) > 2 else None
            y = np.atleast_2d(np.asarray(y, np.float32))
            tids.append(int(tid))
            counts.append(y.shape[0])
            ys.append(y)
            if u is not None:
                u = np.asarray(u, np.float32)
                us.append(u.reshape(y.shape[0], -1))
        if us and len(us) != len(ys):
            raise WireError("mixed with/without-u chunks in one batch")
        return IngestBatch(
            twin_ids=np.asarray(tids, np.int64),
            counts=np.asarray(counts, np.int32),
            y=(np.concatenate(ys) if ys
               else np.zeros((0, 0), np.float32)),
            u=np.concatenate(us) if us else None,
            force=force)

    def chunks(self):
        """Iterate (twin_id, y, u|None) — the `ingest_many` batch shape."""
        off = 0
        for tid, c in zip(self.twin_ids, self.counts):
            c = int(c)
            u = self.u[off:off + c] if self.u is not None else None
            yield int(tid), self.y[off:off + c], u
            off += c

    @property
    def n_samples(self) -> int:
        return int(self.counts.sum())


@_message
@dataclass
class TickCmd:
    """Coordinator -> worker: run one serving tick under `grant` active
    slots.  `inject_delay_s` forwards the chaos straggler schedule so the
    sleep lands INSIDE the worker's timed tick, exactly like the in-process
    supervisor."""
    TYPE = "tick"
    tick: int
    grant: int = -1                    # -1: keep the current grant
    inject_delay_s: float = 0.0


@_message
@dataclass
class TickDone:
    """Worker -> coordinator: the per-tick report, flattened to scalars +
    the guard-event log — everything `ShardedTickReport` aggregates,
    nothing that would leak worker internals across the wire."""
    TYPE = "tick_done"
    tick: int
    latency_s: float
    deadline_met: bool
    n_active: int
    n_twins: int
    n_guarded: int
    degraded_level: int
    pressure: float                    # refit_pressure() for the federation
    loss: float | None = None
    ckpt_tick: int | None = None       # newest COMMITTED checkpoint tick
    events: list = field(default_factory=list)
                                       # [[twin_id, kind, score, tick], ...]


@_message
@dataclass
class Deploy:
    """Coordinator -> worker: warm-start thetas (`deploy_many` shape)."""
    TYPE = "deploy"
    _ARRAY_FIELDS = ("twin_ids", "thetas")
    twin_ids: np.ndarray               # int64 [k]
    thetas: np.ndarray                 # [k, ...] or broadcast [...]


@_message
@dataclass
class PredictCmd:
    TYPE = "predict"
    _ARRAY_FIELDS = ("us",)
    twin_id: int
    horizon: int
    us: np.ndarray | None = None


@_message
@dataclass
class PredictResult:
    TYPE = "predict_result"
    _ARRAY_FIELDS = ("ys",)
    ys: np.ndarray


@_message
@dataclass
class Scenario:
    """Coordinator -> worker: batched what-if query for one twin.

    `us` [K, horizon, m] counterfactual input sequences (None: zero
    inputs, K taken from `k`).  The worker's OWN degradation level decides
    shrink/refuse — the policy must live next to the ladder it reads."""
    TYPE = "scenario"
    _ARRAY_FIELDS = ("us",)
    twin_id: int
    horizon: int
    k: int | None = None
    us: np.ndarray | None = None


@_message
@dataclass
class ScenarioResult:
    """Worker -> coordinator: the flattened `twin.scenario.ScenarioResult`
    (center trajectories + ensemble envelope + per-scenario confidence)."""
    TYPE = "scenario_result"
    _ARRAY_FIELDS = ("ys", "lo", "hi", "confidence")
    twin_id: int
    horizon: int
    requested_k: int
    k: int
    degraded_level: int
    ys: np.ndarray                     # [K, H+1, n] live-theta center
    lo: np.ndarray                     # [K, H+1, n] ensemble lower envelope
    hi: np.ndarray                     # [K, H+1, n] ensemble upper envelope
    confidence: np.ndarray             # [K] in (0, 1]


@_message
@dataclass
class DrainCmd:
    """Ingest barrier; worker replies Ack when staged samples hit rings."""
    TYPE = "drain"


@_message
@dataclass
class Ack:
    TYPE = "ack"
    n: int = 0                         # e.g. samples staged by an ingest


@_message
@dataclass
class StatsCmd:
    TYPE = "stats"
    kind: str = "latency"              # latency | stage | reset


@_message
@dataclass
class Stats:
    TYPE = "stats_result"
    data: dict = field(default_factory=dict)


@_message
@dataclass
class SnapshotCmd:
    TYPE = "snapshot"


@_message
@dataclass
class SnapshotBlob:
    """Worker -> coordinator: the pickled host tree of `snapshot_state()`.
    TRUSTED pipes only -- `decode(trusted=False)` (the front door) refuses
    it."""
    TYPE = "snapshot_blob"
    _ARRAY_FIELDS = ("payload",)
    payload: np.ndarray                # uint8 pickle bytes

    @staticmethod
    def pack(state) -> "SnapshotBlob":
        return SnapshotBlob(payload=np.frombuffer(
            pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL), np.uint8))

    def unpack(self):
        return pickle.loads(self.payload.tobytes())


@_message
@dataclass
class Shutdown:
    TYPE = "shutdown"


@_message
@dataclass
class ErrorMsg:
    """Worker -> coordinator: a tick/command raised.  The coordinator
    treats this like a process death (kill + supervised restart)."""
    TYPE = "error"
    where: str = ""
    error: str = ""


_UNTRUSTED_OK = frozenset({"ingest", "ack", "error"})


# --------------------------------------------------------------------------- #
# codec
# --------------------------------------------------------------------------- #
def encode(msg) -> bytes:
    """Message dataclass -> one wire payload (no outer length prefix)."""
    cls = type(msg)
    array_fields = getattr(cls, "_ARRAY_FIELDS", ())
    header: dict = {"t": cls.TYPE}
    manifest = []
    blobs = []
    for f in fields(cls):
        val = getattr(msg, f.name)
        if f.name in array_fields:
            if val is None:
                manifest.append([f.name, None, None])
            else:
                # record the shape BEFORE ascontiguousarray: it promotes
                # 0-d arrays to 1-d, which would corrupt the round trip
                val = np.asarray(val)
                shape = list(val.shape)
                arr = np.ascontiguousarray(val)
                manifest.append([f.name, str(arr.dtype), shape])
                blobs.append(arr.tobytes())
        else:
            header[f.name] = val
    if manifest:
        header["a"] = manifest
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([_HDR.pack(WIRE_VERSION, len(hdr)), hdr, *blobs])


def decode(payload: bytes, *, trusted: bool = True):
    """One wire payload -> message dataclass.  `trusted=False` is the
    network front door: only `_UNTRUSTED_OK` types are admitted (nothing
    that deserializes beyond JSON + raw arrays)."""
    if len(payload) < _HDR.size:
        raise WireError(f"short frame ({len(payload)} bytes)")
    version, hdr_len = _HDR.unpack_from(payload)
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION} "
                        "(restart the older side)")
    end = _HDR.size + hdr_len
    if end > len(payload):
        raise WireError("header overruns frame")
    try:
        header = json.loads(payload[_HDR.size:end])
        tag = header.pop("t")
        cls = _REGISTRY[tag]
    except (ValueError, KeyError) as e:
        raise WireError(f"bad header: {e!r}") from e
    if not trusted and tag not in _UNTRUSTED_OK:
        raise WireError(f"message type {tag!r} not allowed on an "
                        "untrusted transport")
    kwargs = {}
    off = end
    manifest = header.pop("a", [])
    if not isinstance(manifest, list):
        raise WireError("bad header: array manifest is not a list")
    for entry in manifest:
        try:
            name, dtype, shape = entry
        except (TypeError, ValueError) as e:
            raise WireError(f"bad manifest entry: {entry!r}") from e
        if dtype is None:
            kwargs[name] = None
            continue
        # a flipped bit in the manifest must surface as WireError, not as
        # numpy's TypeError/ValueError/OverflowError zoo
        try:
            arr = np.dtype(dtype)
            n = int(np.prod(shape, dtype=np.int64)) * arr.itemsize
            if n < 0:
                raise WireError(f"blob {name!r} has negative size")
            if off + n > len(payload):
                raise WireError(f"blob {name!r} overruns frame")
            kwargs[name] = np.frombuffer(
                payload[off:off + n], arr).reshape(shape)
        except WireError:
            raise
        except Exception as e:
            raise WireError(f"bad blob {name!r}: {e!r}") from e
        off += n
    kwargs.update(header)
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise WireError(f"bad fields for {tag!r}: {e}") from e


# --------------------------------------------------------------------------- #
# stream framing (TCP)
# --------------------------------------------------------------------------- #
def write_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) > _MAX_FRAME:
        raise WireError(f"frame too large ({len(payload)} bytes)")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None                # peer closed
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> bytes | None:
    """One length-prefixed payload, or None on clean EOF."""
    raw = _read_exact(sock, _LEN.size)
    if raw is None:
        return None
    (n,) = _LEN.unpack(raw)
    if n > _MAX_FRAME:
        raise WireError(f"frame length {n} exceeds {_MAX_FRAME}")
    payload = _read_exact(sock, n)
    if payload is None:
        raise WireError("EOF mid-frame")
    return payload


# --------------------------------------------------------------------------- #
# ingestion front door
# --------------------------------------------------------------------------- #
class IngestFrontDoor:
    """Length-prefixed TCP door decoupling telemetry producers from the
    serving loop.  Accepts ONLY `IngestBatch` frames (untrusted decode),
    hands each to `sink(chunks, force=...) -> samples`, replies `Ack(n)`
    — or `ErrorMsg`, keeping the connection alive, so one bad producer
    frame cannot take the door down.  `sink` is typically
    `FederationCoordinator.ingest_many` (journal-first, then routed), and
    must be thread-safe: each producer connection gets its own thread.
    """

    def __init__(self, sink, host: str = "127.0.0.1", port: int = 0):
        self._sink = sink
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.address = self._srv.getsockname()     # (host, bound_port)
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="frontdoor-accept", daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="frontdoor-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                payload = read_frame(conn)
                if payload is None:
                    return
                try:
                    msg = decode(payload, trusted=False)
                    if not isinstance(msg, IngestBatch):
                        raise WireError(f"front door expects ingest, got "
                                        f"{type(msg).TYPE!r}")
                    n = self._sink(list(msg.chunks()), force=msg.force)
                    reply = Ack(n=int(n))
                except WireError as e:
                    reply = ErrorMsg(where="front_door", error=str(e))
                write_frame(conn, encode(reply))
        except (OSError, WireError):
            pass                        # connection torn down under us
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            for c in self._conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                c.close()
        self._srv.close()
        self._accept.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=2.0)


class FrontDoorClient:
    """What a telemetry producer embeds: pack chunks, send, await Ack.
    One socket, synchronous request/response; producers wanting pipelining
    open more clients."""

    def __init__(self, address):
        self._sock = socket.create_connection(address)

    def ingest_many(self, batch, *, force: bool = False) -> int:
        """Send (twin_id, y[, u]) chunks; returns samples staged server-side
        (the `TwinService.ingest_many` contract, across the network)."""
        write_frame(self._sock,
                    encode(IngestBatch.from_chunks(batch, force=force)))
        payload = read_frame(self._sock)
        if payload is None:
            raise WireError("front door closed the connection")
        reply = decode(payload, trusted=False)
        if isinstance(reply, ErrorMsg):
            raise WireError(f"front door rejected batch: {reply.error}")
        return reply.n

    def ingest(self, twin_id: int, y, u=None, *, force: bool = False) -> int:
        chunk = (twin_id, y) if u is None else (twin_id, y, u)
        return self.ingest_many([chunk], force=force)

    def close(self) -> None:
        self._sock.close()
