"""Record-key codec shared by both stores.

The paper keys records by "ID(s)" — one or more index columns (§4.5.1).  The
stores operate on a single int64 surrogate key: a single integer join key maps
identically (so tests/debugging stay transparent); composite keys are mixed
into 64 bits (splitmix64) — a documented collision assumption at ~2^-64 per
pair, the standard trade for fixed-width device-side key tables.
Live keys are forced non-negative so the online store's -1 sentinel is safe.

Multi-home sharding (``regions.ShardMap``) needs a UNIFORM coordinate over
``[0, 2**KEY_SPACE_BITS)`` so contiguous hash ranges split load evenly with
no per-key placement table.  Encoded keys are NOT that coordinate: the
single-integer transparency path above passes raw ids through unmixed, so
small id universes would all land in the first range.  ``shard_coordinate``
is: one more splitmix64 round over the encoded key, sign bit cleared —
uniform regardless of which encode path produced the key, and the SAME
mapping on every writer, so routing and the rebalance range filter agree.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "KEY_SPACE_BITS",
    "encode_keys",
    "encode_full_keys",
    "shard_coordinate",
]

#: Width of the shard-placement keyspace: ``shard_coordinate`` maps every
#: encoded key uniformly into [0, 2**63).  ShardMap range bounds live in
#: the same interval.
KEY_SPACE_BITS = 63

_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * _C1
    z = (z ^ (z >> np.uint64(27))) * _C2
    return z ^ (z >> np.uint64(31))


def encode_keys(columns: list[np.ndarray]) -> np.ndarray:
    """Combine one or more ID columns into non-negative int64 keys."""
    if len(columns) == 1 and np.issubdtype(np.asarray(columns[0]).dtype, np.integer):
        vals = np.asarray(columns[0], dtype=np.int64)
        if (vals >= 0).all():
            return vals
    acc = np.zeros(len(columns[0]), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for col in columns:
            col = np.asarray(col)
            if np.issubdtype(col.dtype, np.integer):
                h = _splitmix64(col.astype(np.int64).view(np.uint64))
            else:
                h = _hash_object_column(col)
            acc = _splitmix64(acc ^ h)
    return (acc >> np.uint64(1)).view(np.int64)  # clear sign bit


def shard_coordinate(keys: np.ndarray) -> np.ndarray:
    """Uniform placement coordinate of ALREADY-ENCODED entity keys:
    uint64 in ``[0, 2**KEY_SPACE_BITS)``.

    One splitmix64 round over the encoded key, sign bit cleared.  This —
    not the raw encoded key — is what ``regions.ShardMap`` range-partitions
    and what the delta-bootstrap ``key_range`` filter masks on: the
    single-integer encode path is an identity mapping (transparency for
    tests/debugging), so raw keys cluster at the bottom of the keyspace
    whenever ids are small, while this coordinate is uniform for every
    encode path.  Pure per-key function, so every region computes the same
    routing with no coordination."""
    with np.errstate(over="ignore"):
        h = _splitmix64(np.asarray(keys, np.int64).view(np.uint64))
    return h >> np.uint64(1)


def encode_full_keys(ids: np.ndarray, event_ts: np.ndarray, creation_ts) -> np.ndarray:
    """Mix the offline store's FULL record key (id, event_ts, creation_ts)
    into one int64 — the §4.5 idempotence check key.

    Same splitmix64 composition (and the same documented ~2^-64 collision
    assumption) as composite entity keys above; collapsing the triple to a
    fixed-width integer is what lets full-key dedup run as a single sorted
    int64 ``searchsorted`` instead of tuple-set membership.
    """
    with np.errstate(over="ignore"):
        ev = np.asarray(event_ts, np.int64).view(np.uint64)
        cr = np.asarray(creation_ts, np.int64).view(np.uint64)
        # two mix rounds: ids and event_ts are decorrelated by the first,
        # creation_ts (constant per batch) folds into the second — one
        # fewer full-array pass than mixing each field separately
        h = _splitmix64(
            np.asarray(ids, np.int64).view(np.uint64) ^ (ev << np.uint64(1))
        )
        h = _splitmix64(h ^ ev ^ cr)
    # non-negative so signed and unsigned sort orders coincide (radix sort)
    return (h >> np.uint64(1)).view(np.int64)


def _hash_object_column(col: np.ndarray) -> np.ndarray:
    """Vectorized, process-stable hash of a non-integer id column.

    Values are rendered to a fixed-width unicode array, viewed as a
    (N, W) codepoint matrix, and folded one splitmix round per character
    column — O(W) vector ops instead of a per-row Python ``hash(str(v))``
    (which was also salted per process and therefore unusable for any
    persisted or cross-process key comparison).
    """
    s = col if col.dtype.kind == "U" else col.astype(np.str_)
    n = len(s)
    lengths = np.char.str_len(s).astype(np.uint64)
    width = s.dtype.itemsize // 4  # UCS4 codepoints per cell (array max)
    with np.errstate(over="ignore"):
        # Seed with the TRUE per-string length and only fold codepoints
        # inside it, so a value hashes identically regardless of the fixed
        # width of the array it happens to arrive in (write/read batches
        # rarely share a max width).
        h = _splitmix64(lengths)
        if width == 0:
            return h
        codes = np.ascontiguousarray(s).view(np.uint32).reshape(n, width)
        for j in range(width):
            active = j < lengths
            h = np.where(active, _splitmix64(h ^ codes[:, j].astype(np.uint64)), h)
    return h
