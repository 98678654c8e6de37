"""The port's wire codec (``repro_torch.core.wire``) against the JAX
package's (``repro.core.wire``) on the same numpy-seeded batches.

Frames are bytes that cross between regions, so the two packages must
agree byte for byte: every encoder (``encode_run``, ``encode_batch``,
``encode_probe``, ``encode_ack``, ``encode_control``) gives identical bytes
for both planes, compressed and not; a frame encoded by either package
decodes in the other to an equal batch; and ``StreamDecoder`` yields the
same events and counters on the same damaged streams."""

import zlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import replication as jrep  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro_torch.core import replication as trep  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402

PKGS = {"jax": (jwire, jrep), "torch": (twire, trep)}
DTYPES = (np.int64, np.int32, np.int16, np.uint8, np.uint64, np.float64,
          np.float32, np.float16, np.bool_)


def batch_arrays(rng, plane, rows, d=3, seq=0, dtypes=(np.int64, np.float32)):
    """The fields of one seeded batch, as numpy arrays both packages take."""
    out = {
        "seq": seq, "table": ("fs", 1), "plane": plane,
        "creation_ts": int(rng.integers(0, 2**40)),
        "keys": rng.integers(0, 2**62, rows).astype(np.int64),
        "event_ts": rng.integers(0, 2**40, rows).astype(np.int64),
    }
    if plane == "online":
        out["values"] = rng.random((rows, d)).astype(np.float32)
        return out
    out["values"] = np.empty((rows, 0), np.float32)
    cols = {"entity_id": rng.integers(0, 100, rows).astype(np.int64)}
    for i, dt in enumerate(map(np.dtype, dtypes)):
        if dt.kind == "f":
            cols[f"f{i}"] = rng.random(rows).astype(dt)
        elif dt.kind == "b":
            cols[f"f{i}"] = rng.integers(0, 2, rows).astype(dt)
        else:
            cols[f"f{i}"] = rng.integers(0, min(2**62, int(np.iinfo(dt).max)) + 1,
                                         rows).astype(dt)
    out["columns"] = cols
    return out


def make(pkg, fields):
    return PKGS[pkg][1].ReplicatedBatch(**fields)


def assert_same_batch(a, b):
    assert (a.seq, a.table, a.creation_ts, a.plane) == (b.seq, b.table, b.creation_ts, b.plane)
    for name in ("keys", "event_ts", "values"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    if a.columns is None:
        assert b.columns is None
    else:
        assert list(a.columns) == list(b.columns)
        for k in a.columns:
            assert a.columns[k].dtype == b.columns[k].dtype, k
            np.testing.assert_array_equal(a.columns[k], b.columns[k], err_msg=k)


def seeded_run(plane, n, seed, rows=None):
    rng = np.random.default_rng(seed)
    return [batch_arrays(rng, plane, int(rng.integers(0, 60)) if rows is None else rows,
                         seq=i) for i in range(n)]


@pytest.mark.parametrize("compress_level", [None, 0, 1, 6])
@pytest.mark.parametrize("plane", ["online", "offline"])
def test_encoders_byte_identical(plane, compress_level):
    """One batch and a coalesced run of five: identical frames and ledgers."""
    fields = seeded_run(plane, 5, seed=11 if plane == "online" else 12)
    fields[2]["keys"] = np.zeros(len(fields[2]["keys"]), np.int64)  # compressible
    for run in ([fields[0]], fields):
        fj = jwire.encode_run([make("jax", f) for f in run], compress_level=compress_level)
        ft = twire.encode_run([make("torch", f) for f in run], compress_level=compress_level)
        assert ft.data == fj.data
        assert (ft.raw_nbytes, ft.seqs, ft.rows, ft.plane, ft.table) == (
            fj.raw_nbytes, fj.seqs, fj.rows, fj.plane, fj.table)
    one = fields[3]
    assert (twire.encode_batch(make("torch", one), compress_level=compress_level).data
            == jwire.encode_batch(make("jax", one), compress_level=compress_level).data)


@pytest.mark.parametrize("dtype", DTYPES)
def test_offline_columns_byte_identical_every_dtype(dtype):
    rng = np.random.default_rng(7)
    fields = batch_arrays(rng, "offline", 33, dtypes=(dtype, dtype, np.int64))
    for level in (0, 6):
        assert (twire.encode_batch(make("torch", fields), compress_level=level).data
                == jwire.encode_batch(make("jax", fields), compress_level=level).data)


def test_probe_ack_control_byte_identical():
    assert twire.encode_probe().data == jwire.encode_probe().data
    assert twire.encode_probe().table == jwire.encode_probe().table
    rng = np.random.default_rng(3)
    for status in (twire.ACK_OK, twire.ACK_CORRUPT, twire.ACK_APPLY_ERROR):
        seqs = [int(s) for s in rng.integers(-1, 2**40, int(rng.integers(0, 9)))]
        crc = int(rng.integers(0, 2**32))
        assert (twire.encode_ack(status, crc, 1234, seqs)
                == jwire.encode_ack(status, crc, 1234, seqs))
    for msg in ({"cmd": "hello"}, {"cmd": "dump", "table": ["fs", 1], "plane": "offline",
                                   "chunk_rows": 65536},
                {"cmd": "register", "schema": {"name": "fs", "features": [["f0", "float32"]],
                                               "join_keys": ["entity_id"], "version": 1}}):
        assert twire.encode_control(msg) == jwire.encode_control(msg)
        assert twire.frame_message(twire.encode_control(msg)) == jwire.frame_message(
            jwire.encode_control(msg))
    assert (twire.BOOTSTRAP_SEQ, twire.HEADER_SIZE, twire.DEFAULT_COMPRESS_LEVEL) == (
        jwire.BOOTSTRAP_SEQ, jwire.HEADER_SIZE, jwire.DEFAULT_COMPRESS_LEVEL)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("compress_level", [0, 1])
def test_cross_package_decode(src, dst, compress_level):
    """Frames encoded by one package decode in the other to equal batches,
    and acks and controls cross the same way."""
    enc, dec = PKGS[src][0], PKGS[dst][0]
    for plane, seed in (("online", 21), ("offline", 22)):
        fields = seeded_run(plane, 4, seed)
        frame = enc.encode_run([make(src, f) for f in fields], compress_level=compress_level)
        got = dec.decode_frame(frame.data)
        assert len(got) == len(fields)
        for f, b in zip(fields, got):
            assert type(b) is PKGS[dst][1].ReplicatedBatch
            assert_same_batch(make(src, f), b)
            assert not b.keys.flags.writeable
        one = dec.decode_batch(enc.encode_batch(make(src, fields[0])).data)
        assert_same_batch(make(src, fields[0]), one)
    assert dec.decode_frame(enc.encode_probe().data) == []
    ack = dec.decode_ack(enc.encode_ack(enc.ACK_APPLY_ERROR, 0xDEADBEEF, 17, [3, 4, -1]))
    assert (ack.status, ack.msg_crc, ack.rows, ack.seqs) == (2, 0xDEADBEEF, 17, (3, 4, -1))
    msg = {"cmd": "ledger", "x": [1, 2]}
    assert dec.decode_control(enc.encode_control(msg)) == msg


def damaged_stream(seed):
    """A stream of framed frames, controls and acks with damage the decoder
    must survive: a flipped payload byte (intact envelope), a torn length
    prefix, garbage between messages and a truncated tail."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(12):
        kind = i % 3
        if kind == 0:
            plane = "online" if i % 2 else "offline"
            payload = jwire.encode_batch(make("jax", batch_arrays(rng, plane, 20, seq=i))).data
        elif kind == 1:
            payload = jwire.encode_control({"cmd": "register", "i": i})
        else:
            payload = jwire.encode_ack(0, int(rng.integers(0, 2**32)), i, [i, i + 1])
        msg = bytearray(jwire.frame_message(payload))
        if i in (4, 9):  # flip one payload byte: checksum rejects it
            msg[4 + int(rng.integers(6, len(payload)))] ^= 0xFF
        if i == 6:  # torn envelope: an implausible length prefix
            msg[0:4] = (1 << 30).to_bytes(4, "little")
        msgs.append(bytes(msg))
        if i in (2, 7):  # garbage between messages
            msgs.append(rng.integers(0, 256, 37, dtype=np.uint8).tobytes())
    stream = b"".join(msgs)
    return stream[:-7], rng  # a torn tail


def event_signature(ev):
    out = [ev.kind, ev.msg_crc, ev.nbytes, ev.error]
    if ev.batches is not None:
        out.append([(b.seq, b.plane, b.rows, zlib.crc32(b.keys.tobytes())) for b in ev.batches])
    if ev.control is not None:
        out.append(sorted(ev.control.items()))
    if ev.ack is not None:
        out.append((ev.ack.status, ev.ack.msg_crc, ev.ack.rows, ev.ack.seqs))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_decoder_resyncs_identically(seed):
    stream, rng = damaged_stream(seed)
    cuts = np.sort(rng.choice(np.arange(1, len(stream)), 25, replace=False))
    chunks = [stream[a:b] for a, b in zip([0, *cuts], [*cuts, len(stream)])]
    sigs, counters = {}, {}
    for name, (w, _) in PKGS.items():
        dec = w.StreamDecoder()
        sigs[name] = [event_signature(ev) for c in chunks for ev in dec.feed(c)]
        counters[name] = (dec.messages, dec.corrupt_messages, dec.resyncs,
                          dec.skipped_bytes, dec.buffered_bytes)
    assert sigs["torch"] == sigs["jax"]
    assert counters["torch"] == counters["jax"]
    kinds = [s[0] for s in sigs["torch"]]
    assert "corrupt" in kinds and {"frame", "control", "ack"} <= set(kinds)
    assert counters["torch"][2] > 0  # the torn envelope forced a resync
