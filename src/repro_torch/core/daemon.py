"""Replica daemon: the real-socket carrier for geo-replication.

Everything above this module — the seq-ordered ``ReplicationLog``, the
``DeliveryState`` machine, the v2 ``core/wire.py`` frame codec — is
transport-agnostic; until now the one hop between publisher and replica
was an in-process function call (``InProcessChannel``).  This module
implements the hop for real: a **replica daemon** runs an
``OnlineStore`` + ``OfflineStore`` pair in a child process, receives
length-prefixed wire frames over a localhost TCP socket, applies them,
and acks the applied seqs back; a **``SocketChannel``** speaks the same
protocol from the publisher side, implementing the ``Channel.transmit``
seam (plus a pipelined ``post``/``collect`` interface the bounded
in-flight ``GeoReplicator`` drain window uses so encode, socket
transfer, and replica apply overlap instead of serializing).

Socket carrier protocol
-----------------------
One TCP connection carries a full-duplex stream of length-prefixed
messages in both directions (framing and codecs in ``core/wire.py``'s
stream-framing section)::

    u32 payload_len (little-endian) | payload

The payload's first two bytes name its kind:

``"FW"`` — a wire frame
    Exactly the bytes ``wire.encode_run`` produced (self-checksummed v2
    header + records).  Publisher -> daemon: a coalesced run of
    replicated batches, a bootstrap chunk (seq == ``BOOTSTRAP_SEQ``), or
    a zero-batch probe.  Daemon -> publisher: dump chunks streamed in
    reply to a ``dump`` control request.

``"FC"`` — a control message
    ``"FC" | u32 crc32(body) | body``, body UTF-8 JSON, always a dict
    with a ``"cmd"`` key.  Request/reply in FIFO order on the
    connection.  Verbs::

        hello     -> {ok, region, proto, pid, engine, device, offline}
        register  {schema}          -> {ok, table}   (idempotent)
        dump      {table, plane, chunk_rows} -> {ok, frames, rows},
                  then exactly ``frames`` "FW" messages of BOOTSTRAP_SEQ
                  batches (online: grouped by creation_ts; offline:
                  per-row creation_ts rides as a wire column)
        ledger    -> {ok, ledger}   (apply + stream-health counters)
        shutdown  -> {ok}, then the daemon closes every connection and
                  exits its serve loop (exit code 0)

``"FA"`` — an ack
    ``"FA" | u32 crc32(body) | body`` where body is ``u8 status |
    u32 msg_crc | i64 rows | u32 n_seqs | i64 seqs[n]``.  The daemon
    acks EVERY "FW" message it can attribute: ``msg_crc`` echoes crc32
    of the exact message payload bytes received — the publisher's
    correlation token (retried frames re-encode to identical bytes, so
    a late ack resolves the retry; the log's per-seq dedup makes that
    safe).  ``status`` is ``ACK_OK``, ``ACK_CORRUPT`` (checksum or
    structure rejected — nothing applied; the publisher counts a
    crc-reject and retries), or ``ACK_APPLY_ERROR`` (``seqs`` holds the
    applied prefix, so partial progress is never un-acked).

Handshake is implicit: connect, optionally ``hello``, then ship.  Table
schemas travel once per table as a ``register`` control (specs carry
arbitrary user transform code, which never crosses the wire — only the
JSON-serializable schema subset the apply path needs: entity join keys,
feature names/dtypes, plane enablement).  Shutdown is either a
``shutdown`` control or just closing the socket; the daemon also exits
after ``--idle-timeout`` seconds without traffic, so an orphaned child
whose parent died without cleanup reaps itself.

Fault-injecting proxy mode: give ``SocketChannel`` a seeded
``channel.FaultPlan`` and it perturbs its OWN sends deterministically —
drops (frame never hits the socket), duplicates (sent twice; the
daemon's idempotent apply absorbs the second), corruption (one byte
flipped inside the frame payload, envelope intact, so the daemon NACKs
with ``ACK_CORRUPT``), lost acks (the ack is awaited, then discarded),
and latency spikes (the measured RTT is inflated past the publisher's
ack timeout).  The ``DeliveryState`` machine above sees exactly the
failure surface it was chaos-tested against, now over a real socket.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import dataclasses
import os
import select
import selectors
import socket
import subprocess
import sys
import time
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.assets import (
    Entity,
    Feature,
    FeatureSetSpec,
    MaterializationSettings,
)
from repro_torch.core.channel import Delivery, FaultPlan
from repro_torch.core.dsl import UDFTransform
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS, OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.regions import GeoTopology
from repro_torch.core.replication import ReplicatedBatch
from repro_torch.device import resolve_device
from repro_torch.kernels import native

__all__ = [
    "DaemonHandle",
    "ReplicaDaemon",
    "SocketChannel",
    "schema_from_spec",
    "spec_from_schema",
    "spawn_replica_daemon",
]

PROTO_VERSION = 1
_BANNER = "REPLICA_DAEMON_LISTENING"
_RECV_CHUNK = 1 << 16


# -- schema transfer ----------------------------------------------------------
#
# FeatureSetSpec carries a transform (arbitrary user code — lambdas,
# closures); the replica apply path (merge_reduced / apply_chunks) never
# runs it, so only the schema subset crosses the wire and the daemon
# rebuilds a spec around an identity placeholder.


def schema_from_spec(spec: FeatureSetSpec) -> dict:
    """The JSON-serializable subset of a spec the replica apply path needs."""
    return {
        "name": spec.name,
        "version": spec.version,
        "entity": spec.entity.name,
        "join_keys": list(spec.entity.join_keys),
        "features": [[f.name, f.dtype] for f in spec.features],
        "online": bool(spec.materialization.online_enabled),
        "offline": bool(spec.materialization.offline_enabled),
    }


def spec_from_schema(schema: dict) -> FeatureSetSpec:
    """Rebuild an apply-side spec from a shipped schema dict."""
    return FeatureSetSpec(
        name=schema["name"],
        version=int(schema["version"]),
        entity=Entity(schema.get("entity", "entity"), tuple(schema["join_keys"])),
        features=tuple(Feature(n, d) for n, d in schema["features"]),
        source_name="__replicated__",
        transform=UDFTransform(lambda df, ctx: df, name="identity"),
        materialization=MaterializationSettings(
            offline_enabled=bool(schema.get("offline", True)),
            online_enabled=bool(schema.get("online", True)),
        ),
    )


# -- daemon (replica side) ----------------------------------------------------


class _Shutdown(Exception):
    """Raised inside the serve loop when a shutdown control arrives."""


class ReplicaDaemon:
    """A replica's store pair plus the socket protocol around it.

    Single-threaded event loop over a listening socket: any number of
    concurrent connections (the publisher's data connection plus
    control-only connections, e.g. the spawn helper's shutdown), each
    with its own ``StreamDecoder``, messages handled in arrival order.
    All apply-side semantics are exactly ``GeoReplicator._apply_decoded``:
    ``merge_reduced`` online (latest-wins, idempotent), ``apply_chunks``
    offline (full-key dedup), so redelivery and out-of-order frames
    converge here the same way they do in-process."""

    def __init__(
        self,
        *,
        region: str = "replica",
        merge_engine: str = "vector",
        offline: bool = True,
        num_partitions: int = 16,
        initial_capacity: int = 256,
        offline_shards: int = 4,
        device: str | torch.device = "cuda",
    ) -> None:
        self.region = region
        self.merge_engine = merge_engine
        self.online = OnlineStore(
            num_partitions, initial_capacity, merge_engine=merge_engine,
            device=device,
        )
        self.offline: Optional[OfflineStore] = (
            OfflineStore(offline_shards, merge_engine=merge_engine)
            if offline
            else None
        )
        self._specs: dict[tuple[str, int], FeatureSetSpec] = {}
        #: shipped-frame ledger — what the transport smoke logs for
        #: debuggability and tests assert against
        self.ledger: dict[str, int] = {
            "messages": 0,
            "frames": 0,
            "probes": 0,
            "batches_applied": 0,
            "rows_applied": 0,
            "controls": 0,
            "dump_frames": 0,
            "nacks": 0,
            "apply_errors": 0,
        }
        self._stream_base = {"corrupt_messages": 0, "resyncs": 0, "skipped_bytes": 0}
        self._decoders: dict[int, wire.StreamDecoder] = {}

    # -- apply ----------------------------------------------------------------
    def _register(self, schema: dict) -> FeatureSetSpec:
        key = (schema["name"], int(schema["version"]))
        spec = self._specs.get(key)
        if spec is None:
            spec = spec_from_schema(schema)
            self._specs[key] = spec
        if spec.materialization.online_enabled:
            self.online.register(spec)
        if self.offline is not None and spec.materialization.offline_enabled:
            self.offline.register(spec)
        return spec

    def _apply(self, batch: ReplicatedBatch) -> dict:
        spec = self._specs[batch.table]  # unannounced table -> apply error
        if batch.plane == "offline":
            if self.offline is None:
                raise RuntimeError("daemon runs without an offline plane")
            cols = dict(batch.columns or {})
            creation = cols.pop(CREATION_TS, batch.creation_ts)
            return self.offline.apply_chunks(
                spec, batch.keys, batch.event_ts, creation, cols
            )
        return self.online.merge_reduced(
            spec, batch.keys, batch.event_ts, batch.values, batch.creation_ts
        )

    def _handle_frame(self, ev: wire.StreamEvent) -> bytes:
        """Apply one decoded frame's batches; return the ack payload."""
        self.ledger["frames"] += 1
        if not ev.batches:
            self.ledger["probes"] += 1
        status = wire.ACK_OK
        seqs: list[int] = []
        rows = 0
        for b in ev.batches or ():
            try:
                self._apply(b)
            except Exception:
                # ack the applied prefix rather than losing it; the
                # publisher treats APPLY_ERROR as a delivery failure
                status = wire.ACK_APPLY_ERROR
                self.ledger["apply_errors"] += 1
                break
            seqs.append(b.seq)
            rows += b.rows
        self.ledger["batches_applied"] += len(seqs)
        self.ledger["rows_applied"] += rows
        return wire.encode_ack(status, ev.msg_crc, rows, seqs)

    # -- dump (promotion adoption / verification) ------------------------------
    def _dump_frames(
        self, table: tuple[str, int], plane: str, chunk_rows: int
    ) -> list[wire.WireFrame]:
        """The daemon-side mirror of ``bootstrap_delta``'s chunking: the
        replica's current state for one (table, plane) as BOOTSTRAP_SEQ
        wire frames, bounded at ``chunk_rows`` rows apiece."""
        spec = self._specs.get(table)
        frames: list[wire.WireFrame] = []
        if spec is None:
            return frames
        name, version = table
        if plane == "online" and self.online.has(name, version):
            dump = self.online.dump_all(name, version)
            if len(dump):
                keys = dump["__key__"]
                event_ts = dump[EVENT_TS]
                creation_ts = dump[CREATION_TS]
                values = dump.column_stack(
                    [f.name for f in spec.features], np.float32
                )
                for cr in np.unique(creation_ts):
                    idx = np.flatnonzero(creation_ts == cr)
                    for lo in range(0, len(idx), chunk_rows):
                        sl = idx[lo : lo + chunk_rows]
                        frames.append(
                            wire.encode_batch(
                                ReplicatedBatch(
                                    seq=wire.BOOTSTRAP_SEQ,
                                    table=table,
                                    creation_ts=int(cr),
                                    keys=keys[sl],
                                    event_ts=event_ts[sl],
                                    values=values[sl],
                                )
                            )
                        )
        elif (
            plane == "offline"
            and self.offline is not None
            and self.offline.has(name, version)
        ):
            for chunk in self.offline.export_chunks(
                name, version, max_rows=chunk_rows
            ):
                if len(chunk) == 0:
                    continue
                cols = {
                    k: chunk[k]
                    for k in chunk.names
                    if k not in ("__key__", EVENT_TS)
                }
                frames.append(
                    wire.encode_batch(
                        ReplicatedBatch(
                            seq=wire.BOOTSTRAP_SEQ,
                            table=table,
                            creation_ts=int(chunk[CREATION_TS][0]),
                            keys=chunk["__key__"],
                            event_ts=chunk[EVENT_TS],
                            values=np.empty((len(chunk), 0), np.float32),
                            plane="offline",
                            columns=cols,
                        )
                    )
                )
        return frames

    # -- control --------------------------------------------------------------
    def _stream_counters(self) -> dict:
        out = dict(self._stream_base)
        for dec in self._decoders.values():
            out["corrupt_messages"] += dec.corrupt_messages
            out["resyncs"] += dec.resyncs
            out["skipped_bytes"] += dec.skipped_bytes
        return out

    def _handle_control(self, msg: dict) -> list[bytes]:
        """Execute one control verb; return the reply messages (already
        length-prefixed).  Raises ``_Shutdown`` after a shutdown reply."""
        self.ledger["controls"] += 1
        cmd = msg.get("cmd")
        if cmd == "hello":
            reply = {
                "ok": True,
                "cmd": "hello",
                "proto": PROTO_VERSION,
                "region": self.region,
                "pid": os.getpid(),
                "engine": self.merge_engine,
                "device": str(self.online.device),
                "offline": self.offline is not None,
            }
            return [wire.frame_message(wire.encode_control(reply))]
        if cmd == "register":
            spec = self._register(msg["schema"])
            reply = {"ok": True, "cmd": "register", "table": list(spec.key)}
            return [wire.frame_message(wire.encode_control(reply))]
        if cmd == "dump":
            table = tuple(msg["table"])
            frames = self._dump_frames(
                table, msg.get("plane", "online"), int(msg.get("chunk_rows", 65_536))
            )
            self.ledger["dump_frames"] += len(frames)
            reply = {
                "ok": True,
                "cmd": "dump",
                "frames": len(frames),
                "rows": sum(f.rows for f in frames),
            }
            out = [wire.frame_message(wire.encode_control(reply))]
            out += [wire.frame_message(f.data) for f in frames]
            return out
        if cmd == "ledger":
            ledger = dict(self.ledger)
            ledger.update(self._stream_counters())
            return [
                wire.frame_message(
                    wire.encode_control({"ok": True, "cmd": "ledger", "ledger": ledger})
                )
            ]
        if cmd == "shutdown":
            raise _Shutdown()
        reply = {"ok": False, "cmd": cmd, "error": f"unknown control verb {cmd!r}"}
        return [wire.frame_message(wire.encode_control(reply))]

    # -- event loop ------------------------------------------------------------
    def _handle_events(
        self, conn: socket.socket, events: list[wire.StreamEvent]
    ) -> None:
        for ev in events:
            self.ledger["messages"] += 1
            if ev.kind == "frame":
                conn.sendall(wire.frame_message(self._handle_frame(ev)))
            elif ev.kind == "corrupt":
                # intact envelope, rejected payload: NACK it by content
                # crc so the publisher's crc-reject path fires promptly
                # instead of waiting out the ack timeout
                self.ledger["nacks"] += 1
                conn.sendall(
                    wire.frame_message(
                        wire.encode_ack(wire.ACK_CORRUPT, ev.msg_crc, 0, ())
                    )
                )
            elif ev.kind == "control":
                try:
                    for reply in self._handle_control(ev.control):
                        conn.sendall(reply)
                except _Shutdown:
                    conn.sendall(
                        wire.frame_message(
                            wire.encode_control({"ok": True, "cmd": "shutdown"})
                        )
                    )
                    raise
            # stray acks are ignored: the daemon never sends frames that
            # expect acknowledgement

    def serve_forever(
        self, sock: socket.socket, *, idle_timeout: Optional[float] = None
    ) -> None:
        """Serve until a shutdown control arrives or the stream has been
        idle for ``idle_timeout`` seconds (orphan self-reaping)."""
        sel = selectors.DefaultSelector()
        sock.setblocking(False)
        sel.register(sock, selectors.EVENT_READ, data="listener")
        last_traffic = time.monotonic()
        try:
            while True:
                ready = sel.select(timeout=1.0)
                if (
                    idle_timeout is not None
                    and time.monotonic() - last_traffic > idle_timeout
                ):
                    return
                for key, _ in ready:
                    if key.data == "listener":
                        conn, _addr = sock.accept()
                        conn.setblocking(True)
                        conn.setsockopt(
                            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                        )
                        self._decoders[conn.fileno()] = wire.StreamDecoder()
                        sel.register(conn, selectors.EVENT_READ, data="conn")
                        continue
                    conn = key.fileobj
                    fd = conn.fileno()
                    data = b""
                    try:
                        data = conn.recv(_RECV_CHUNK)
                    except (ConnectionResetError, OSError):
                        pass
                    if not data:
                        dec = self._decoders.pop(fd, None)
                        if dec is not None:
                            for k in self._stream_base:
                                self._stream_base[k] += getattr(dec, k)
                        sel.unregister(conn)
                        conn.close()
                        continue
                    last_traffic = time.monotonic()
                    try:
                        self._handle_events(conn, self._decoders[fd].feed(data))
                    except _Shutdown:
                        return
                    except (BrokenPipeError, ConnectionResetError):
                        dec = self._decoders.pop(fd, None)
                        if dec is not None:
                            for k in self._stream_base:
                                self._stream_base[k] += getattr(dec, k)
                        sel.unregister(conn)
                        conn.close()
        finally:
            for key in list(sel.get_map().values()):
                if key.data == "conn":
                    key.fileobj.close()
            sel.close()
            self._decoders.clear()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="replica daemon: apply wire frames from a socket"
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--region", default="replica")
    ap.add_argument("--engine", default="vector",
                    choices=("vector", "kernel", "loop"))
    ap.add_argument("--no-offline", action="store_true")
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="the replica store's device; 'cuda' raises without a card")
    ap.add_argument(
        "--idle-timeout",
        type=float,
        default=900.0,
        help="exit after this many silent seconds (orphan self-reaping); "
        "<= 0 disables",
    )
    args = ap.parse_args(argv)
    daemon = ReplicaDaemon(
        region=args.region,
        merge_engine=args.engine,
        offline=not args.no_offline,
        num_partitions=args.partitions,
        initial_capacity=args.capacity,
        device=args.device,
    )
    if daemon.online.device.type == "cuda":
        # load the kernel library: spawn_replica_daemon built it before
        # spawning (same sources, same hash), so a spawned child finds it
        # and never compiles alongside its parent
        native.library()
    sock = socket.create_server((args.host, args.port))
    # the banner is the spawn contract: parents block on this line to
    # learn the ephemeral port, so it must be the first stdout output
    print(f"{_BANNER} {sock.getsockname()[1]}", flush=True)
    try:
        daemon.serve_forever(
            sock,
            idle_timeout=args.idle_timeout if args.idle_timeout > 0 else None,
        )
    finally:
        sock.close()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())


# -- spawn helper (publisher side) --------------------------------------------


class DaemonHandle:
    """A spawned replica daemon child: its port, its process, and a
    teardown that cannot orphan it (shutdown control -> wait -> terminate
    -> kill, also registered via ``atexit``)."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int) -> None:
        self.proc = proc
        self.host = host
        self.port = port
        self._closed = False
        atexit.register(self.close)

    def connect(self, timeout: float = 10.0) -> socket.socket:
        sock = socket.create_connection((self.host, self.port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def control(self, msg: dict, *, timeout: float = 10.0) -> Optional[dict]:
        """One-shot control request over a fresh connection."""
        with self.connect(timeout=timeout) as sock:
            sock.sendall(wire.frame_message(wire.encode_control(msg)))
            sock.settimeout(timeout)
            dec = wire.StreamDecoder()
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    data = sock.recv(_RECV_CHUNK)
                except (socket.timeout, OSError):
                    return None
                if not data:
                    return None
                for ev in dec.feed(data):
                    if ev.kind == "control":
                        return ev.control
        return None

    def close(self, timeout: float = 5.0) -> None:
        """Guaranteed teardown: polite shutdown first, escalate to
        terminate/kill — never leaves an orphan, green run or red."""
        if self._closed:
            return
        self._closed = True
        if self.proc.poll() is None:
            try:
                self.control({"cmd": "shutdown"}, timeout=2.0)
            except OSError:
                pass
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()

    def __enter__(self) -> "DaemonHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn_replica_daemon(
    *,
    region: str = "replica",
    merge_engine: str = "vector",
    offline: bool = True,
    num_partitions: int = 16,
    initial_capacity: int = 256,
    idle_timeout: float = 900.0,
    startup_timeout: float = 120.0,
    device: str | torch.device = "cuda",
) -> DaemonHandle:
    """Launch ``python -m repro_torch.core.daemon`` as a child process and block
    until it announces its ephemeral port on stdout.  For a ``cuda`` replica
    the kernel library is built here first, so the child loads it and never
    compiles alongside its parent; asking for ``cuda`` with no card raises
    here, before anything is spawned."""
    device = resolve_device(device)
    if device.type == "cuda":
        native.build()
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    cmd = [
        sys.executable,
        "-m",
        "repro_torch.core.daemon",
        "--region", region,
        "--engine", merge_engine,
        "--partitions", str(num_partitions),
        "--capacity", str(initial_capacity),
        "--idle-timeout", str(idle_timeout),
        "--device", str(device),
    ]
    if not offline:
        cmd.append("--no-offline")
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, env=env, text=True, bufsize=1
    )
    deadline = time.monotonic() + startup_timeout
    port: Optional[int] = None
    assert proc.stdout is not None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break  # child died before announcing
        if line.startswith(_BANNER):
            port = int(line.split()[1])
            break
    if port is None:
        proc.kill()
        proc.wait()
        raise RuntimeError(
            f"replica daemon for {region} failed to announce a port within "
            f"{startup_timeout:.0f}s"
        )
    return DaemonHandle(proc, "127.0.0.1", port)


# -- publisher-side channel ---------------------------------------------------


@dataclasses.dataclass
class _Send:
    """One posted frame awaiting its ack — the pipelined in-flight unit."""

    crc: int
    frame: object
    t0: float
    faults: tuple[str, ...] = ()
    ack_lost: bool = False
    extra_ms: float = 0.0
    delivery: Optional[Delivery] = None
    #: emulated-link maturity: the completion is not released to the
    #: caller before this monotonic instant (see ``min_rtt_ms``)
    ready_at: float = 0.0


class SocketChannel:
    """``Channel.transmit`` over a real socket to a replica daemon.

    Synchronous ``transmit`` posts one frame and blocks for its ack (or
    the timeout) — the drop-in carrier for the unchanged ``DeliveryState``
    machine.  The pipelined interface the bounded-window drain uses::

        token = ch.post(frame)      # None = injector ate it
        done  = ch.collect(ms)      # [(token, Delivery), ...] as acks land
        ch.forget(token)            # abandon an expired in-flight send

    Acks correlate to sends by content crc (see the module docstring), so
    a late ack from a timed-out transmit resolves the identical retry —
    at-least-once delivery with the log's per-seq dedup on top, exactly
    the in-process contract.

    ``fault_plan`` enables proxy mode: the plan's seeded schedule perturbs
    this channel's own sends (drop / dup / corrupt / ack_loss / spike;
    reorder is meaningless on one TCP stream and ignored).  ``counts``
    tallies injected faults like ``FaultyChannel.counts``.

    ``min_rtt_ms`` is netem-style link emulation: an ack is withheld from
    the caller until at least that long after its frame was posted, as if
    the bytes had crossed a WAN with that round-trip.  Localhost acks
    return in microseconds, which hides exactly the stall the pipelined
    window exists to absorb — with an emulated RTT the serialized path
    honestly pays one round-trip per frame while the windowed path keeps
    the link full.  The daemon still receives and applies frames at
    socket speed; only completion release is delayed (0 = off)."""

    is_remote = True

    def __init__(
        self,
        sock: socket.socket,
        *,
        src: str = "home",
        dst: str = "replica",
        topology: Optional[GeoTopology] = None,
        fault_plan: Optional[FaultPlan] = None,
        ack_timeout_ms: float = 5_000.0,
        min_rtt_ms: float = 0.0,
    ) -> None:
        self.sock = sock
        self.src = src
        self.dst = dst
        self.topology = topology
        self.plan = fault_plan
        self.ack_timeout_ms = float(ack_timeout_ms)
        self.min_rtt_ms = float(min_rtt_ms)
        self.sock.setblocking(True)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._dec = wire.StreamDecoder()
        self._inflight: collections.deque[_Send] = collections.deque()
        self._completed: collections.deque[_Send] = collections.deque()
        self._ctrl_replies: collections.deque[dict] = collections.deque()
        self._dump_sink: Optional[list] = None
        self._tables: set[tuple[str, int]] = set()
        self.events: dict[str, int] = {}
        self.counts: dict[str, int] = {
            k: 0
            for k in (
                "transmits",
                "dropped",
                "duplicated",
                "corrupted",
                "ack_lost",
                "spiked",
                "partitioned",
                "stray_acks",
            )
        }

    # -- schema announcement ---------------------------------------------------
    def ensure_table(self, spec: FeatureSetSpec) -> None:
        """Announce one table's schema to the daemon (once per table)."""
        if spec.key in self._tables:
            return
        reply = self.request(
            {"cmd": "register", "schema": schema_from_spec(spec)}
        )
        if not (reply and reply.get("ok")):
            raise ConnectionError(f"replica daemon rejected schema: {reply}")
        self._tables.add(spec.key)

    # -- control request/reply -------------------------------------------------
    def request(
        self, msg: dict, *, timeout_ms: Optional[float] = None
    ) -> Optional[dict]:
        """Synchronous control round-trip (FIFO with any in-flight acks)."""
        self.sock.sendall(wire.frame_message(wire.encode_control(msg)))
        deadline = time.monotonic() + (
            timeout_ms if timeout_ms is not None else self.ack_timeout_ms
        ) / 1000.0
        while not self._ctrl_replies and time.monotonic() < deadline:
            self._pump(deadline)
        return self._ctrl_replies.popleft() if self._ctrl_replies else None

    def fetch_dump(
        self,
        spec: FeatureSetSpec,
        plane: str,
        *,
        chunk_rows: int = 65_536,
        timeout_ms: float = 60_000.0,
    ) -> list[ReplicatedBatch]:
        """Pull the daemon's current state for one (table, plane) as
        decoded BOOTSTRAP_SEQ batches — promotion adoption and the
        convergence checks read replica state through this."""
        sink: list[ReplicatedBatch] = []
        self._dump_sink = sink
        try:
            reply = self.request(
                {
                    "cmd": "dump",
                    "table": list(spec.key),
                    "plane": plane,
                    "chunk_rows": chunk_rows,
                },
                timeout_ms=timeout_ms,
            )
            if not (reply and reply.get("ok")):
                raise ConnectionError(f"dump of {spec.key} failed: {reply}")
            want = int(reply["frames"])
            deadline = time.monotonic() + timeout_ms / 1000.0
            while len(sink) < want and time.monotonic() < deadline:
                self._pump(deadline)
            if len(sink) < want:
                raise ConnectionError(
                    f"dump of {spec.key} truncated: {len(sink)}/{want} frames"
                )
        finally:
            self._dump_sink = None
        out: list[ReplicatedBatch] = []
        for batches in sink:
            out.extend(batches)
        return out

    def ledger(self) -> Optional[dict]:
        reply = self.request({"cmd": "ledger"})
        return reply.get("ledger") if reply else None

    # -- pipelined sends ---------------------------------------------------------
    def post(self, frame) -> Optional[_Send]:
        """Send one frame without waiting; returns the in-flight token, or
        None when the fault injector dropped the send entirely."""
        event = self.events.get(self.dst, 0)
        self.events[self.dst] = event + 1
        self.counts["transmits"] += 1
        faults: list[str] = self.plan.decide(self.dst, event) if self.plan else []
        if "partition" in faults:
            self.counts["partitioned"] += 1
            return None
        if "drop" in faults:
            self.counts["dropped"] += 1
            return None
        data = frame.data
        if "corrupt" in faults:
            self.counts["corrupted"] += 1
            data = self.plan.corrupt(self.dst, event, data)
        msg = wire.frame_message(data)
        self.sock.sendall(msg)
        if "dup" in faults:
            self.counts["duplicated"] += 1
            self.sock.sendall(msg)
        extra_ms = 0.0
        if "spike" in faults:
            self.counts["spiked"] += 1
            extra_ms = self.plan.spike_ms
        ack_lost = "ack_lost" in faults
        if ack_lost:
            self.counts["ack_lost"] += 1
        entry = _Send(
            crc=zlib.crc32(data),
            frame=frame,
            t0=time.monotonic(),
            faults=tuple(faults),
            ack_lost=ack_lost,
            extra_ms=extra_ms,
        )
        self._inflight.append(entry)
        return entry

    def _release_matured(self) -> list[tuple[_Send, Delivery]]:
        """Completions whose emulated-link maturity has passed.  Uniform
        ``min_rtt_ms`` keeps the completed deque ordered by ``ready_at``,
        so releasing is a prefix pop."""
        now = time.monotonic()
        out = []
        while self._completed and self._completed[0].ready_at <= now:
            entry = self._completed.popleft()
            out.append((entry, entry.delivery))
        return out

    def collect(self, timeout_ms: float) -> list[tuple[_Send, Delivery]]:
        """Wait up to ``timeout_ms`` for at least one in-flight completion
        to mature; drain and return everything matured so far."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            out = self._release_matured()
            if out:
                return out
            if not self._inflight and not self._completed:
                return []
            if time.monotonic() >= deadline:
                return []
            # wake at the earlier of the caller's deadline and the first
            # held completion's maturity instant
            wake = deadline
            if self._completed:
                wake = min(wake, self._completed[0].ready_at)
            if not self._pump(wake) and not self._completed:
                return []  # EOF (or deadline) with nothing held back

    def forget(self, token: _Send) -> None:
        """Abandon an expired in-flight send; its late ack (if any) will
        count as a stray or resolve a future identical retry."""
        try:
            self._inflight.remove(token)
        except ValueError:
            pass

    def transmit(self, src: str, dst: str, frame) -> Delivery:
        """The serialized ``Channel`` contract: post, await the ack."""
        token = self.post(frame)
        if token is None:
            return Delivery(
                arrivals=(),
                latency_ms=self.ack_timeout_ms,
                faults=("partition",) if self._partitioned_last() else ("drop",),
            )
        deadline = time.monotonic() + self.ack_timeout_ms / 1000.0
        while token.delivery is None and time.monotonic() < deadline:
            if not self._pump(deadline):
                break
        if token.delivery is None:
            self.forget(token)
            return Delivery(
                arrivals=(),
                latency_ms=self.ack_timeout_ms,
                faults=token.faults + ("timeout",),
            )
        # honor the emulated link: block until the ack would have arrived
        wait = token.ready_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        try:
            self._completed.remove(token)
        except ValueError:
            pass
        return token.delivery

    def _partitioned_last(self) -> bool:
        plan, event = self.plan, self.events.get(self.dst, 1) - 1
        return bool(plan) and plan.partitioned(self.dst, event)

    # -- socket pump -------------------------------------------------------------
    def _pump(self, deadline: float) -> bool:
        """Read whatever the daemon sent (acks, control replies, dump
        frames) and route it.  Returns False on timeout/EOF."""
        wait = deadline - time.monotonic()
        if wait <= 0:
            return False
        ready, _, _ = select.select([self.sock], [], [], min(wait, 0.2))
        if not ready:
            return True  # keep waiting until the caller's deadline
        data = self.sock.recv(_RECV_CHUNK)
        if not data:
            return False
        for ev in self._dec.feed(data):
            if ev.kind == "ack":
                self._resolve(ev.ack)
            elif ev.kind == "control":
                self._ctrl_replies.append(ev.control)
            elif ev.kind == "frame":
                if self._dump_sink is not None:
                    self._dump_sink.append(ev.batches)
            # corrupt events on the return path are dropped: the
            # publisher-side retry machinery covers lost acks already
        return True

    def _resolve(self, ack: wire.Ack) -> None:
        rtt_ms = None
        for entry in self._inflight:
            if entry.crc == ack.msg_crc:
                rtt_ms = max(
                    (time.monotonic() - entry.t0) * 1e3, self.min_rtt_ms
                )
                entry.delivery = Delivery(
                    arrivals=(),
                    latency_ms=rtt_ms + entry.extra_ms,
                    ack_lost=entry.ack_lost,
                    faults=entry.faults,
                    remote=ack,
                )
                entry.ready_at = entry.t0 + self.min_rtt_ms / 1000.0
                self._inflight.remove(entry)
                self._completed.append(entry)
                break
        if rtt_ms is None:
            self.counts["stray_acks"] += 1
        elif self.topology is not None:
            self.topology.observe_rtt(self.src, self.dst, rtt_ms)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
