"""Wire format for replica-bound ``ReplicatedBatch``es (ROADMAP: WAN
transport realism).

Until now the replication log handed replicas live in-process numpy
references: shipped-byte numbers were estimates (``ReplicatedBatch.nbytes``)
and a replica could in principle alias the publisher's buffers.  This module
is the actual transport encoding — every batch a replica receives has been
serialized into one contiguous byte buffer and decoded back out, exactly
what a multi-process deployment would put on the WAN — so shipped bytes are
MEASURED (``len(frame.data)``), compression is real (zlib, level
configurable, ratio recorded), and replicas physically cannot share memory
with the home store (decoded arrays are read-only views of the received
buffer).

Frame layout (little-endian throughout)
---------------------------------------
One FRAME carries one or more batches (a coalesced run shares a single
header and a single compression stream)::

    magic "FW" | u8 version | u8 flags (bit0: zlib) | u32 batch_count
    | u64 raw_payload_len | u32 crc32 | payload

``crc32`` (wire version 2) is the checksum of the WHOLE frame as
shipped — the header with the crc field zeroed, then the payload exactly
as transmitted (post-compression).  The magic/length checks catch
truncation and framing damage but passed silently-corrupted raw payload
arrays straight into replica state, and a payload-only checksum leaves
the header's own bytes unprotected (a flipped ``flags`` bit nothing
validates decodes "successfully"), so the decoder verifies the frame
checksum right after the magic/version gate and rejects any mismatch
with ``WireFormatError`` — a fault-injected (or real) WAN bit-flip
ANYWHERE in the frame surfaces as a detected delivery failure the
publisher retries, never as divergent replica bytes.  ``batch_count == 0``
is a valid frame (``encode_probe``): an empty payload the delivery state
machine uses to re-probe a DEAD replica's link without touching any store.

``payload`` is the concatenation of batch records, zlib-compressed when
flags bit0 is set.  Each batch record::

    i64 seq | i64 creation_ts | u8 plane (0=online, 1=offline)
    | u8 has_columns | u16 table_name_len | table_name utf8
    | u32 table_version
    | array keys | array event_ts | array values
    | if has_columns: u32 n_cols, then per column:
        u16 name_len | name utf8 | array

and an ARRAY is dtype-tagged and shape-prefixed::

    u16 dtype_len | numpy dtype.str utf8 | u8 ndim | u32 dims[ndim]
    | raw C-order bytes

The dtype tag carries the full numpy dtype string (``"<i8"``, ``"<f4"``,
...), so offline batches ship their record-schema columns in NATIVE dtypes
and decode bit-exact.  ``seq == -1`` marks an out-of-log frame (delta-
bootstrap chunks, which are not replication-log entries and are never
acked).

Coalescing
----------
``coalesce`` groups a replica's pending batches into maximal runs of
adjacent same-plane same-table batches; ``encode_run`` packs one run into
one frame (one header, one zlib stream over the concatenated records — the
cross-batch redundancy is what the shared stream exploits).  Decoding a
coalesced frame yields the constituent batches in sequence order, each with
its own ``seq``, so the replica acks exactly the same per-batch sequence it
would have acked un-coalesced.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

# DEFAULT_COMPRESS_LEVEL lives in replication.py (the first module of the
# replication<->wire pair to finish importing) and is re-exported here as
# the codec's canonical knob: zlib levels 1..9 trade cpu for ratio, 0/None
# ships raw.
from repro_torch.core.replication import DEFAULT_COMPRESS_LEVEL, ReplicatedBatch

__all__ = [
    "ACK_APPLY_ERROR",
    "ACK_CORRUPT",
    "ACK_OK",
    "Ack",
    "DEFAULT_COMPRESS_LEVEL",
    "HEADER_SIZE",
    "MAX_MESSAGE_BYTES",
    "StreamDecoder",
    "StreamEvent",
    "WireFrame",
    "WireFormatError",
    "coalesce",
    "decode_ack",
    "decode_batch",
    "decode_control",
    "decode_frame",
    "encode_ack",
    "encode_batch",
    "encode_control",
    "encode_probe",
    "encode_run",
    "frame_message",
]

MAGIC = b"FW"
#: v2: +u32 crc32 of the shipped frame (zeroed-crc header +
#: payload) in the header; v1 frames (no checksum) are rejected — silent
#: corruption is worse than a loud version mismatch on a mixed-version link
VERSION = 2
FLAG_ZLIB = 0x01
#: out-of-log sentinel: bootstrap chunks ship over the wire but are not
#: replication-log entries and must never be acked
BOOTSTRAP_SEQ = -1
#: table tag on zero-batch probe frames (never registered, never applied)
PROBE_TABLE = ("__probe__", 0)

_HEADER = struct.Struct("<2sBBIQI")
#: fixed per-frame envelope cost — what break-even accounting must add to
#: the raw payload when comparing against wire bytes
HEADER_SIZE = _HEADER.size
_BATCH_HEAD = struct.Struct("<qqBBH")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_PLANE_CODE = {"online": 0, "offline": 1}
_PLANE_NAME = {v: k for k, v in _PLANE_CODE.items()}


class WireFormatError(ValueError):
    """Malformed or foreign bytes handed to the decoder."""


@dataclasses.dataclass(frozen=True)
class WireFrame:
    """One encoded wire message plus its shipping ledger.

    ``data`` is the only thing that crosses the (modeled) WAN;
    ``raw_nbytes``/``wire_nbytes`` are the measured sizes the shipping
    accounting and the bandwidth cost model consume."""

    data: bytes
    raw_nbytes: int  # serialized payload before compression
    seqs: tuple[int, ...]
    rows: int
    plane: str
    table: tuple[str, int]

    @property
    def wire_nbytes(self) -> int:
        return len(self.data)

    @property
    def compression_ratio(self) -> float:
        """raw/wire for the payload+header actually shipped (>= 1.0 when
        compression wins; ~1.0 when disabled or incompressible)."""
        return (self.raw_nbytes + _HEADER.size) / max(self.wire_nbytes, 1)


# -- encode -------------------------------------------------------------------


def _frame_crc(flags: int, batch_count: int, raw_len: int, payload: bytes) -> int:
    """crc32 over the whole frame with the header's crc field zeroed —
    the checksum covers the header's own fields, so a flipped flag bit or
    length byte is as loudly rejected as a flipped payload byte."""
    head = _HEADER.pack(MAGIC, VERSION, flags, batch_count, raw_len, 0)
    return zlib.crc32(payload, zlib.crc32(head))


def _encode_array(out: list[bytes], a: np.ndarray) -> None:
    a = np.ascontiguousarray(a)
    tag = a.dtype.str.encode()
    out.append(_U16.pack(len(tag)))
    out.append(tag)
    out.append(struct.pack("<B", a.ndim))
    out.append(struct.pack(f"<{a.ndim}I", *a.shape))
    out.append(a.tobytes())


def _encode_record(batch: ReplicatedBatch) -> bytes:
    name = batch.table[0].encode()
    out: list[bytes] = [
        _BATCH_HEAD.pack(
            batch.seq,
            batch.creation_ts,
            _PLANE_CODE[batch.plane],
            1 if batch.columns is not None else 0,
            len(name),
        ),
        name,
        _U32.pack(batch.table[1]),
    ]
    _encode_array(out, batch.keys)
    _encode_array(out, batch.event_ts)
    _encode_array(out, batch.values)
    if batch.columns is not None:
        out.append(_U32.pack(len(batch.columns)))
        for cname, col in batch.columns.items():
            cb = cname.encode()
            out.append(_U16.pack(len(cb)))
            out.append(cb)
            _encode_array(out, col)
    return b"".join(out)


def encode_run(
    batches: Sequence[ReplicatedBatch],
    *,
    compress_level: Optional[int] = DEFAULT_COMPRESS_LEVEL,
) -> WireFrame:
    """Serialize a run of same-plane same-table batches into ONE frame.

    The run shares a single header and a single compression stream; pass a
    single batch for the un-coalesced path.  ``compress_level`` 0/None
    ships the payload raw (the flag bit tells the decoder which)."""
    if not batches:
        raise ValueError("cannot encode an empty run")
    plane, table = batches[0].plane, batches[0].table
    for b in batches[1:]:
        if b.plane != plane or b.table != table:
            raise ValueError(
                f"coalesced run must share (plane, table): "
                f"{(plane, table)} vs {(b.plane, b.table)}"
            )
    payload = b"".join(_encode_record(b) for b in batches)
    raw_len = len(payload)
    flags = 0
    if compress_level:
        packed = zlib.compress(payload, compress_level)
        # incompressible payloads ship raw rather than paying the zlib
        # envelope for nothing; the flag bit keeps decode unambiguous
        if len(packed) < raw_len:
            payload, flags = packed, FLAG_ZLIB
    # checksum the frame AS SHIPPED (header with the crc field zeroed +
    # post-compression payload): the receiver verifies it before touching
    # zlib or the record structure, so WAN corruption anywhere in the
    # frame — header fields included — is rejected at the door instead of
    # decoded into state
    crc = _frame_crc(flags, len(batches), raw_len, payload)
    head = _HEADER.pack(MAGIC, VERSION, flags, len(batches), raw_len, crc)
    return WireFrame(
        data=head + payload,
        raw_nbytes=raw_len,
        seqs=tuple(b.seq for b in batches),
        rows=sum(b.rows for b in batches),
        plane=plane,
        table=table,
    )


def encode_batch(
    batch: ReplicatedBatch,
    *,
    compress_level: Optional[int] = DEFAULT_COMPRESS_LEVEL,
) -> WireFrame:
    """Serialize one batch (either plane) into one contiguous buffer."""
    return encode_run([batch], compress_level=compress_level)


def encode_probe() -> WireFrame:
    """A zero-batch frame: the smallest well-formed wire message.  The
    delivery state machine transmits it to test whether a DEAD replica's
    link carries bytes again — decoding yields no batches, so applying a
    probe touches no store and acks nothing."""
    head = _HEADER.pack(MAGIC, VERSION, 0, 0, 0, _frame_crc(0, 0, 0, b""))
    return WireFrame(
        data=head, raw_nbytes=0, seqs=(), rows=0, plane="online", table=PROBE_TABLE
    )


# -- decode -------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise WireFormatError(
                f"truncated frame: need {n} bytes at offset {self.pos}, "
                f"have {len(self.view) - self.pos}"
            )
        out = self.view[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, s: struct.Struct) -> tuple:
        return s.unpack(self.take(s.size))


def _decode_array(r: _Reader) -> np.ndarray:
    (tag_len,) = r.unpack(_U16)
    dtype = np.dtype(bytes(r.take(tag_len)).decode())
    (ndim,) = struct.unpack("<B", r.take(1))
    shape = struct.unpack(f"<{ndim}I", r.take(4 * ndim))
    count = int(np.prod(shape)) if ndim else 1
    a = np.frombuffer(r.take(count * dtype.itemsize), dtype, count)
    return a.reshape(shape)


def _decode_record(r: _Reader) -> ReplicatedBatch:
    seq, creation_ts, plane_code, has_cols, name_len = r.unpack(_BATCH_HEAD)
    if plane_code not in _PLANE_NAME:
        raise WireFormatError(f"unknown plane code {plane_code}")
    name = bytes(r.take(name_len)).decode()
    (version,) = r.unpack(_U32)
    keys = _decode_array(r)
    event_ts = _decode_array(r)
    values = _decode_array(r)
    columns: Optional[dict[str, np.ndarray]] = None
    if has_cols:
        (n_cols,) = r.unpack(_U32)
        columns = {}
        for _ in range(n_cols):
            (cn_len,) = r.unpack(_U16)
            cname = bytes(r.take(cn_len)).decode()
            columns[cname] = _decode_array(r)
    return ReplicatedBatch(
        seq=seq,
        table=(name, version),
        creation_ts=creation_ts,
        keys=keys,
        event_ts=event_ts,
        values=values,
        plane=_PLANE_NAME[plane_code],
        columns=columns,
    )


def decode_frame(data: bytes) -> list[ReplicatedBatch]:
    """Decode one frame back into its batches, in encoded order.

    Decoded arrays are READ-ONLY zero-copy views of the (decompressed)
    received buffer — the replica-side guarantee that applied state can
    never alias, or be corrupted through, publisher memory."""
    if len(data) < _HEADER.size:
        raise WireFormatError(f"frame shorter than header: {len(data)} bytes")
    magic, version, flags, batch_count, raw_len, crc = _HEADER.unpack(
        data[: _HEADER.size]
    )
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {magic!r}")
    if version != VERSION:
        raise WireFormatError(f"unsupported wire version {version}")
    payload = data[_HEADER.size :]
    # verify the checksum over the frame AS SHIPPED (header fields
    # included), before zlib or any record parsing runs: corrupted bytes
    # are rejected at the door
    got = _frame_crc(flags, batch_count, raw_len, payload)
    if got != crc:
        raise WireFormatError(
            f"frame checksum mismatch: crc32 {got:#010x} != declared {crc:#010x}"
        )
    if flags & ~FLAG_ZLIB:
        # belt over the crc's braces: a sender that stamps a valid
        # checksum over flag bits this version doesn't define is a
        # protocol error, not something to silently ignore
        raise WireFormatError(f"unknown flag bits {flags:#04x}")
    if flags & FLAG_ZLIB:
        dec = zlib.decompressobj()
        try:
            payload = dec.decompress(payload)
        except zlib.error as e:
            raise WireFormatError(f"bad zlib payload: {e}") from None
        if dec.unused_data or dec.unconsumed_tail:
            raise WireFormatError("trailing bytes after compressed payload")
    if len(payload) != raw_len:
        raise WireFormatError(f"payload length {len(payload)} != declared {raw_len}")
    r = _Reader(payload)
    try:
        batches = [_decode_record(r) for _ in range(batch_count)]
    except WireFormatError:
        raise
    except (TypeError, ValueError, UnicodeDecodeError, struct.error) as e:
        # a corrupted dtype tag, non-UTF8 name, or impossible shape must
        # surface as the module's contractual rejection error, not leak the
        # numpy/codec internals to the receiver
        raise WireFormatError(f"malformed frame payload: {e}") from None
    if r.pos != len(payload):
        raise WireFormatError(f"{len(payload) - r.pos} trailing bytes in frame")
    return batches


def decode_batch(data: bytes) -> ReplicatedBatch:
    """Decode a single-batch frame (the un-coalesced fast path)."""
    batches = decode_frame(data)
    if len(batches) != 1:
        raise WireFormatError(f"expected 1 batch in frame, got {len(batches)}")
    return batches[0]


# -- coalescing ---------------------------------------------------------------


def coalesce(
    batches: Iterable[ReplicatedBatch],
) -> list[list[ReplicatedBatch]]:
    """Group pending batches into maximal runs of ADJACENT same-plane
    same-table batches — the unit ``encode_run`` ships as one frame.

    Adjacency (not global grouping) preserves the log's total order on the
    wire: batches arrive and are acked in exactly the sequence the home
    appended them, coalesced or not."""
    runs: list[list[ReplicatedBatch]] = []
    for b in batches:
        if runs and runs[-1][0].plane == b.plane and runs[-1][0].table == b.table:
            runs[-1].append(b)
        else:
            runs.append([b])
    return runs


# -- stream framing -----------------------------------------------------------
#
# A WireFrame is self-checksummed but NOT self-delimiting: the v2 header
# carries the RAW payload length, not the post-compression length, so a
# byte stream of concatenated frames cannot be split without decompressing.
# The socket carrier (core/daemon.py) therefore wraps every message in a
# u32 little-endian length prefix:
#
#     u32 payload_len | payload
#
# and the payload's first two bytes name its kind:
#
#     "FW"  a wire frame (header + payload as produced by encode_run)
#     "FC"  a control message: "FC" | u32 crc32(body) | body (UTF-8 JSON)
#     "FA"  an ack:            "FA" | u32 crc32(body) | body (see _ACK_HEAD)
#
# StreamDecoder reassembles messages from arbitrary recv() chunkings —
# partial reads, messages split across chunks, many messages in one chunk —
# and stays on the air through damage: a message whose envelope is intact
# but whose checksum rejects is surfaced as a "corrupt" event (the
# publisher-visible NACK path), while a torn envelope (bad length or
# unknown magic) triggers a resync scan to the next plausible message
# boundary, counting the bytes skipped.

CONTROL_MAGIC = b"FC"
ACK_MAGIC = b"FA"
_STREAM_MAGICS = (MAGIC, CONTROL_MAGIC, ACK_MAGIC)
#: envelope sanity bound — a length prefix beyond this is treated as framing
#: damage (resync), not as a request to buffer gigabytes
MAX_MESSAGE_BYTES = 1 << 28

#: ack status codes: OK (all batches applied), CORRUPT (frame checksum or
#: structure rejected — the publisher's crc_rejected path), APPLY_ERROR
#: (frame decoded but a batch failed to apply; ``seqs`` holds the applied
#: prefix so prefix acks are never lost)
ACK_OK = 0
ACK_CORRUPT = 1
ACK_APPLY_ERROR = 2

#: u8 status | u32 msg_crc (crc32 of the message payload being acked,
#: exactly as received — the correlation token) | i64 rows | u32 n_seqs
_ACK_HEAD = struct.Struct("<BIqI")


@dataclasses.dataclass(frozen=True)
class Ack:
    """A replica's receipt for one stream message.

    ``msg_crc`` echoes crc32 of the exact payload bytes the replica
    received, which is how the publisher correlates acks to in-flight
    sends (retried frames re-encode to identical bytes, so a late ack
    from a timed-out send resolves the retry — the log's per-seq dedup
    makes that safe)."""

    status: int
    msg_crc: int
    rows: int
    seqs: tuple[int, ...]

    @property
    def ok(self) -> bool:
        return self.status == ACK_OK


def frame_message(payload: bytes) -> bytes:
    """Wrap one message payload in the u32 length-prefix envelope."""
    if len(payload) < 2 or len(payload) > MAX_MESSAGE_BYTES:
        raise WireFormatError(f"message payload of {len(payload)} bytes")
    return _U32.pack(len(payload)) + payload


def encode_ack(status: int, msg_crc: int, rows: int, seqs: Sequence[int]) -> bytes:
    """Encode an ack message payload (pass through ``frame_message``)."""
    body = _ACK_HEAD.pack(status, msg_crc & 0xFFFFFFFF, rows, len(seqs))
    body += struct.pack(f"<{len(seqs)}q", *seqs)
    return ACK_MAGIC + _U32.pack(zlib.crc32(body)) + body


def decode_ack(payload: bytes) -> Ack:
    if payload[:2] != ACK_MAGIC:
        raise WireFormatError(f"bad ack magic {payload[:2]!r}")
    (crc,) = _U32.unpack_from(payload, 2)
    body = payload[6:]
    if zlib.crc32(body) != crc:
        raise WireFormatError("ack checksum mismatch")
    if len(body) < _ACK_HEAD.size:
        raise WireFormatError("truncated ack body")
    status, msg_crc, rows, n_seqs = _ACK_HEAD.unpack_from(body, 0)
    want = _ACK_HEAD.size + 8 * n_seqs
    if len(body) != want:
        raise WireFormatError(f"ack body {len(body)} bytes, expected {want}")
    seqs = struct.unpack_from(f"<{n_seqs}q", body, _ACK_HEAD.size)
    return Ack(status=status, msg_crc=msg_crc, rows=rows, seqs=tuple(seqs))


def encode_control(obj: dict) -> bytes:
    """Encode a control message payload (JSON body, crc-protected)."""
    body = json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    return CONTROL_MAGIC + _U32.pack(zlib.crc32(body)) + body


def decode_control(payload: bytes) -> dict:
    if payload[:2] != CONTROL_MAGIC:
        raise WireFormatError(f"bad control magic {payload[:2]!r}")
    (crc,) = _U32.unpack_from(payload, 2)
    body = payload[6:]
    if zlib.crc32(body) != crc:
        raise WireFormatError("control checksum mismatch")
    try:
        obj = json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"malformed control body: {e}") from None
    if not isinstance(obj, dict):
        raise WireFormatError("control body must be a JSON object")
    return obj


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One decoded stream message (or the carcass of a corrupted one).

    ``kind`` is "frame" / "control" / "ack" / "corrupt"; exactly one of
    ``batches`` / ``control`` / ``ack`` is set for the first three.
    ``msg_crc`` is crc32 of the payload AS RECEIVED — for corrupt events
    it identifies the damaged message so the receiver can NACK it."""

    kind: str
    msg_crc: int
    nbytes: int
    batches: Optional[list[ReplicatedBatch]] = None
    control: Optional[dict] = None
    ack: Optional[Ack] = None
    error: Optional[str] = None


def _plausible_length(n: int) -> bool:
    return 2 <= n <= MAX_MESSAGE_BYTES


class StreamDecoder:
    """Incremental message reassembly over an unreliable byte stream.

    Feed it whatever ``recv`` returns; it yields complete messages and
    never raises on damage.  Counters: ``messages`` (complete envelopes
    consumed), ``corrupt_messages`` (intact envelope, rejected payload),
    ``resyncs`` / ``skipped_bytes`` (torn envelopes scanned past)."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self.messages = 0
        self.corrupt_messages = 0
        self.resyncs = 0
        self.skipped_bytes = 0

    @property
    def buffered_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list[StreamEvent]:
        self._buf += data
        events: list[StreamEvent] = []
        while True:
            ev = self._next()
            if ev is None:
                break
            if ev is not _NO_EVENT:
                events.append(ev)
        return events

    def _next(self):
        buf = self._buf
        if len(buf) < 4:
            return None
        (n,) = _U32.unpack_from(buf, 0)
        if not _plausible_length(n):
            return self._resync()
        if len(buf) >= 6 and bytes(buf[4:6]) not in _STREAM_MAGICS:
            return self._resync()
        if len(buf) < 4 + n:
            return None
        payload = bytes(buf[4 : 4 + n])
        del buf[: 4 + n]
        self.messages += 1
        return self._dispatch(payload)

    def _dispatch(self, payload: bytes) -> StreamEvent:
        crc = zlib.crc32(payload)
        magic = payload[:2]
        try:
            if magic == MAGIC:
                return StreamEvent(
                    "frame", crc, len(payload), batches=decode_frame(payload)
                )
            if magic == CONTROL_MAGIC:
                return StreamEvent(
                    "control", crc, len(payload), control=decode_control(payload)
                )
            return StreamEvent("ack", crc, len(payload), ack=decode_ack(payload))
        except WireFormatError as e:
            self.corrupt_messages += 1
            return StreamEvent("corrupt", crc, len(payload), error=str(e))

    def _resync(self):
        """The envelope itself is torn: scan forward for the next offset
        that looks like a message boundary (plausible u32 length followed
        by a known magic) and drop everything before it."""
        buf = self._buf
        self.resyncs += 1
        for i in range(1, len(buf) - 5):
            (n,) = _U32.unpack_from(buf, i)
            if _plausible_length(n) and bytes(buf[i + 4 : i + 6]) in _STREAM_MAGICS:
                self.skipped_bytes += i
                del buf[:i]
                return _NO_EVENT
        # no boundary in sight: keep a 5-byte tail (a prefix of the next
        # envelope may straddle the chunk edge) and wait for more bytes
        keep = min(len(buf), 5)
        self.skipped_bytes += len(buf) - keep
        del buf[: len(buf) - keep]
        return None


#: sentinel: the decoder made progress (dropped garbage) without yielding
_NO_EVENT = StreamEvent("none", 0, 0)
