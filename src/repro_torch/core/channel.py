"""Fault-injectable WAN channel for the replication transport.

``GeoReplicator._ship_frame`` used to be a perfect in-process call: an
encoded ``core/wire.py`` frame could never drop, duplicate, arrive out of
order, corrupt, or time out, so the delivery state machine above it had
nothing to detect and the standing convergence invariants were only ever
exercised on the happy path.  This module makes the hop pluggable:

  * ``Channel`` — the protocol: ``transmit(src, dst, frame)`` carries one
    encoded ``wire.WireFrame`` toward a replica and returns a ``Delivery``
    describing what actually happened: zero or more ``arrivals`` (the byte
    payloads that reached the destination), the modeled one-way
    ``latency_ms``, and whether the acknowledgement path was lost;
  * ``InProcessChannel`` — today's perfect behavior (exactly one arrival,
    topology-modeled latency, acks always return).  The default, so every
    existing test and benchmark is bit-for-bit unchanged;
  * ``FaultyChannel`` — drops, duplicates, reorders, corrupts, spikes, and
    partitions frames according to a seeded ``FaultPlan``.

Determinism is the design constraint: a chaos run must be reproducible
from one integer seed so CI can gate its retry counts EXACTLY.  The fault
schedule therefore never touches wall-clock time or stateful RNG — every
decision is a pure function of (seed, destination, per-destination event
index) through a splitmix64-style integer hash, and "time" for partition
windows is the per-destination transmit-event counter.  Re-running the
same workload over the same plan replays the same faults, byte for byte.

Fault semantics (what the publisher observes):

  * DROP / PARTITION — no arrival; the publisher sees an ack timeout and
    retries after backoff (the frame's batches stay pending in the log);
  * DUPLICATE — two arrivals; the replica applies both (per-plane
    idempotence makes the second a no-op) and the duplicate is counted;
  * REORDER — the frame is withheld and delivered alongside the NEXT
    transmit to the same destination: the publisher sees a timeout and
    retries, the late copy applies out of order (commutativity) and is
    counted as a redelivery;
  * CORRUPT — the arrival's bytes are flipped; the wire CRC rejects the
    frame on the replica side (``WireFormatError``), no ack returns;
  * LATENCY SPIKE — the frame arrives and applies, but later than the
    publisher's ack timeout: the publisher must retry anyway, and the
    replica-side per-seq dedup absorbs the redelivery;
  * ACK LOSS — same observable outcome as a spike (applied, not acked).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Protocol

from repro_torch.core.regions import GeoTopology

__all__ = [
    "Channel",
    "Delivery",
    "DeliveryError",
    "FaultPlan",
    "FaultyChannel",
    "InProcessChannel",
]

_M64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer: a deterministic integer hash with good
    avalanche — the only "randomness" the fault plan is allowed."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def _uniform(seed: int, dst_key: int, event: int, salt: int) -> float:
    """Deterministic u ~ [0, 1) for one (destination, event, fault-kind)
    triple.  Independent salts give independent per-kind draws."""
    return mix64(seed ^ mix64(dst_key ^ mix64((event << 8) | salt))) / 2.0**64


class DeliveryError(RuntimeError):
    """A transfer that must complete (bootstrap chunk, failover replay)
    exhausted its retry budget against the channel."""


@dataclasses.dataclass(frozen=True)
class Delivery:
    """What one ``transmit`` actually did.

    ``arrivals`` holds every byte payload that reached the destination
    (empty = dropped/partitioned, two entries = duplicated; a reordered
    frame arrives inside a LATER transmit's ``arrivals``).  ``ack_lost``
    means the frame applied but the acknowledgement never made it home —
    observationally identical to a latency spike past the ack timeout.

    ``remote`` is set by out-of-process carriers (``core/daemon.py``'s
    ``SocketChannel``): the replica daemon's ``wire.Ack`` receipt — the
    seqs it applied, rows, and status.  For such carriers ``arrivals`` is
    empty (the bytes left the process; nothing arrives locally) and the
    publisher trusts the ack instead of applying anything itself.  Typed
    as ``object`` because ``channel`` sits below ``wire`` in the import
    order."""

    arrivals: tuple[bytes, ...]
    latency_ms: float
    ack_lost: bool = False
    faults: tuple[str, ...] = ()
    remote: Optional[object] = None


class Channel(Protocol):
    """One-way carrier of encoded wire frames toward a replica."""

    def transmit(self, src: str, dst: str, frame) -> Delivery: ...


class InProcessChannel:
    """The perfect channel: exactly one arrival, topology-priced latency,
    acks always return.  It is the default, so the deterministic
    shipped-byte gates are untouched."""

    def __init__(self, topology: GeoTopology) -> None:
        self.topology = topology

    def transmit(self, src: str, dst: str, frame) -> Delivery:
        return Delivery(
            arrivals=(frame.data,),
            latency_ms=self.topology.transfer_ms(src, dst, frame.wire_nbytes),
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic fault schedule for a ``FaultyChannel``.

    Rates are per-transmit probabilities, decided by hashing (seed,
    destination, per-destination event index) — no RNG state, no clock.
    ``partitions`` are half-open windows ``(dst, start_event, end_event)``
    in the destination's own transmit-event count: every frame (including
    probes) transmitted while the window covers its event index is lost.
    An empty plan is exactly the perfect channel."""

    seed: int
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    reorder_rate: float = 0.0
    corrupt_rate: float = 0.0
    ack_loss_rate: float = 0.0
    spike_rate: float = 0.0
    spike_ms: float = 60_000.0
    partitions: tuple[tuple[str, int, int], ...] = ()

    _SALTS = {
        "drop": 0x11,
        "dup": 0x22,
        "reorder": 0x33,
        "corrupt": 0x44,
        "ack_lost": 0x55,
        "spike": 0x66,
    }

    def partitioned(self, dst: str, event: int) -> bool:
        return any(
            d == dst and lo <= event < hi for d, lo, hi in self.partitions
        )

    def decide(self, dst: str, event: int) -> list[str]:
        """The fault kinds striking this (destination, event) — a pure
        function of the plan, so any run is replayable from the seed."""
        if self.partitioned(dst, event):
            return ["partition"]
        dst_key = zlib.crc32(dst.encode())
        rates = (
            ("drop", self.drop_rate),
            ("dup", self.dup_rate),
            ("reorder", self.reorder_rate),
            ("corrupt", self.corrupt_rate),
            ("ack_lost", self.ack_loss_rate),
            ("spike", self.spike_rate),
        )
        return [
            kind
            for kind, rate in rates
            if rate > 0.0
            and _uniform(self.seed, dst_key, event, self._SALTS[kind]) < rate
        ]

    def corrupt(self, dst: str, event: int, data: bytes) -> bytes:
        """Flip one byte at a plan-determined offset — always an actual
        change, so the wire CRC must catch it."""
        if not data:
            return data
        h = mix64(self.seed ^ zlib.crc32(dst.encode()) ^ mix64(event ^ 0xC0))
        pos = h % len(data)
        flip = ((h >> 17) & 0xFF) or 0xA5  # never XOR with 0 (a no-op)
        return data[:pos] + bytes([data[pos] ^ flip]) + data[pos + 1 :]


class FaultyChannel:
    """A WAN that misbehaves on a reproducible schedule.

    Wraps the topology's latency model like ``InProcessChannel`` and then
    applies the plan's faults per transmit.  ``counts`` tallies every
    fault actually injected (the chaos bench gates these exactly), and
    ``events[dst]`` is the per-destination logical clock the partition
    windows are defined over."""

    def __init__(self, plan: FaultPlan, topology: GeoTopology) -> None:
        self.plan = plan
        self.topology = topology
        self.events: dict[str, int] = {}
        self.counts: dict[str, int] = {
            k: 0
            for k in (
                "transmits",
                "dropped",
                "duplicated",
                "reordered",
                "corrupted",
                "ack_lost",
                "spiked",
                "partitioned",
            )
        }
        self._deferred: dict[str, list[bytes]] = {}

    def transmit(self, src: str, dst: str, frame) -> Delivery:
        event = self.events.get(dst, 0)
        self.events[dst] = event + 1
        self.counts["transmits"] += 1
        faults = self.plan.decide(dst, event)
        latency = self.topology.transfer_ms(src, dst, frame.wire_nbytes)
        # anything withheld by an earlier reorder arrives alongside this
        # transmit — it was overtaken, not lost
        late = tuple(self._deferred.pop(dst, ()))
        arrivals: tuple[bytes, ...] = ()
        ack_lost = False
        if "partition" in faults:
            self.counts["partitioned"] += 1
        elif "drop" in faults:
            self.counts["dropped"] += 1
        elif "reorder" in faults:
            self.counts["reordered"] += 1
            self._deferred.setdefault(dst, []).append(frame.data)
        else:
            data = frame.data
            if "corrupt" in faults:
                self.counts["corrupted"] += 1
                data = self.plan.corrupt(dst, event, data)
            arrivals = (data, data) if "dup" in faults else (data,)
            if "dup" in faults:
                self.counts["duplicated"] += 1
            if "spike" in faults:
                self.counts["spiked"] += 1
                latency += self.plan.spike_ms
            if "ack_lost" in faults:
                self.counts["ack_lost"] += 1
                ack_lost = True
        return Delivery(
            arrivals=late + arrivals,
            latency_ms=latency,
            ack_lost=ack_lost,
            faults=tuple(faults),
        )
