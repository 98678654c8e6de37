"""Rule ``determinism``: no wall clock, no unseeded RNG on the replay surface.

History: PR 7's whole chaos design rests on byte-for-byte replay from one
integer seed — every fault decision is a pure splitmix64 hash, backoff
jitter runs over LOGICAL drain ticks, and the bench gates every chaos count
EXACTLY.  One ``time.time()`` or module-state RNG call on that surface turns
the deterministic ledger into flaky noise.  The port copies that surface and
its contract: its replication data plane (``repro_torch.core``'s
channel/replication/wire/multihome), the daemon's protocol module, and the
port's chaos and multi-home suites (``tests/test_torch_chaos.py``, and
``tests/test_torch_multihome.py``, the counterpart of the JAX package's
shard suite).

Banned: ``time.time``, ``datetime.now``/``utcnow``/``today``, any
``np.random.*`` except a seeded ``default_rng(seed)`` / explicit
``Generator``/bit-generator construction, and every module-level
``random.*`` call (``random.Random(seed)`` instances are fine — they carry
their seed).  Deliberately NOT banned: ``time.monotonic``/``perf_counter``/
``sleep`` — the daemon times out real sockets with real clocks; wall-clock
*measurement* is fine, wall-clock *decision input to replayed logic* is not
(timeouts on a real link are already outside the replay boundary).
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import dotted_name

_WALL_CLOCK = {
    "time.time": "wall clock",
    "time.time_ns": "wall clock",
    "datetime.now": "wall clock",
    "datetime.utcnow": "wall clock",
    "datetime.today": "wall clock",
    "datetime.datetime.now": "wall clock",
    "datetime.datetime.utcnow": "wall clock",
    "datetime.datetime.today": "wall clock",
    "datetime.date.today": "wall clock",
}

#: np.random attributes that construct an explicitly-seeded generator (the
#: seed argument is checked separately for default_rng)
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}


@registry.rule(
    "determinism",
    scope=(
        "src/repro_torch/core/channel.py",
        "src/repro_torch/core/replication.py",
        "src/repro_torch/core/wire.py",
        "src/repro_torch/core/daemon.py",
        "src/repro_torch/core/multihome.py",
        "tests/test_torch_chaos.py",
        "tests/test_torch_multihome.py",
    ),
    description="no wall clock / unseeded RNG on the deterministic-replay "
    "surface (PR 7's byte-replayable chaos contract)",
)
def check(ctx, project):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        if name in _WALL_CLOCK:
            yield ctx.finding(
                "determinism",
                node,
                f"{name}() is a wall clock on the deterministic-replay "
                f"surface; derive times from the logical clock / modeled "
                f"latency instead",
            )
        elif name.startswith(("np.random.", "numpy.random.")):
            attr = name.rsplit(".", 1)[1]
            if attr not in _NP_RANDOM_OK:
                yield ctx.finding(
                    "determinism",
                    node,
                    f"{name}() draws from numpy's module-level RNG state; "
                    f"use an explicitly seeded np.random.default_rng(seed)",
                )
            elif attr == "default_rng" and not (node.args or node.keywords):
                yield ctx.finding(
                    "determinism",
                    node,
                    "np.random.default_rng() without a seed is entropy-"
                    "seeded; pass the scenario seed explicitly",
                )
        elif name.startswith("random."):
            attr = name.split(".", 1)[1]
            if attr == "Random" and (node.args or node.keywords):
                continue  # seeded instance carries its seed
            yield ctx.finding(
                "determinism",
                node,
                f"{name}() uses process-global RNG state on the "
                f"deterministic-replay surface; use a seeded "
                f"np.random.default_rng(seed) or random.Random(seed)",
            )
