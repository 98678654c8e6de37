"""Rule ``gauge-keys``: metric keys are /-segmented; match them segment-wise.

History: PR 9.  ``HealthMonitor.clear_replica_gauges`` matched the replica
name as a raw substring/suffix of gauge keys, so clearing ``r1`` touched
``r11``'s gauges (the substring trap) while per-shard keys that put the
replica MID-path (``replication/shard_lag_batches/{replica}/{shard}``)
were missed entirely — a rejoined region resurrected its pre-eviction lag
readings.  The shipped fix splits the key on ``/`` and matches the replica
as a full segment.  Two sub-checks lock that in:

* keys handed to ``set_gauge``/``inc``/``observe``/``observe_batch`` must be
  string literals or f-strings (the /-segmented shapes the monitor
  documents), never ``+``/``%``/``.format`` concatenations — those are how
  un-segmentable keys get minted;
* any identity test against a metric-key loop variable (a variable iterating
  ``gauges``/``counters``/``histograms``) must be segment-wise: bare
  ``x in key`` substring membership and ``key.startswith/endswith(<dynamic>)``
  are flagged (``key.split("/")`` membership and literal namespace prefixes
  like ``"replication/"`` pass).

The port's monitor and its callers (``repro_torch.core``) keep the same
keys and the same fix.
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import terminal_attr

_RECORDERS = {"set_gauge", "inc", "observe", "observe_batch"}
_METRIC_STORES = {"gauges", "counters", "histograms"}


def _metric_key_vars(tree: ast.AST) -> dict[str, ast.AST]:
    """Loop/comprehension variables that iterate a metrics mapping."""
    out: dict[str, ast.AST] = {}

    def iter_mentions_store(it: ast.AST) -> bool:
        for n in ast.walk(it):
            name = terminal_attr(n) if isinstance(n, (ast.Attribute, ast.Name)) else None
            if name in _METRIC_STORES:
                return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if iter_mentions_store(node.iter) and isinstance(node.target, ast.Name):
                out[node.target.id] = node
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            for gen in node.generators:
                if iter_mentions_store(gen.iter) and isinstance(gen.target, ast.Name):
                    out[gen.target.id] = node
    return out


@registry.rule(
    "gauge-keys",
    scope=(
        "src/repro_torch/core/monitoring.py",
        "src/repro_torch/core/replication.py",
        "src/repro_torch/core/multihome.py",
        "src/repro_torch/core/serving.py",
        "src/repro_torch/core/regions.py",
    ),
    description="metric keys are /-segmented literals/f-strings and are "
    "matched segment-wise, never by substring (the PR-9 r1-vs-r11 "
    "clear_replica_gauges trap)",
)
def check(ctx, project):
    key_vars = _metric_key_vars(ctx.tree)

    for node in ast.walk(ctx.tree):
        # -- sub-check 1: key construction at the recorder call site --------
        if isinstance(node, ast.Call):
            meth = terminal_attr(node.func)
            if (
                meth in _RECORDERS
                and isinstance(node.func, ast.Attribute)
                and node.args
            ):
                key = node.args[0]
                if isinstance(key, ast.BinOp) or (
                    isinstance(key, ast.Call)
                    and terminal_attr(key.func) == "format"
                ):
                    yield ctx.finding(
                        "gauge-keys",
                        key,
                        f"metric key for .{meth}() is built by concatenation/"
                        f".format(); use a /-segmented literal or f-string so "
                        f"segment-wise matching stays possible",
                    )
        # -- sub-check 2: identity tests on metric-key variables -------------
        if isinstance(node, ast.Compare):
            for op, comparator in zip(node.ops, node.comparators):
                if not isinstance(op, (ast.In, ast.NotIn)):
                    continue
                if (
                    isinstance(comparator, ast.Name)
                    and comparator.id in key_vars
                ):
                    yield ctx.finding(
                        "gauge-keys",
                        node,
                        f"substring membership on metric key "
                        f"{comparator.id!r} confuses 'r1' with 'r11'; match "
                        f"full segments: x in {comparator.id}.split(\"/\")",
                    )
        if isinstance(node, ast.Call):
            meth = terminal_attr(node.func)
            if meth in ("startswith", "endswith") and isinstance(
                node.func, ast.Attribute
            ):
                target = node.func.value
                if (
                    isinstance(target, ast.Name)
                    and target.id in key_vars
                    and node.args
                ):
                    arg = node.args[0]
                    is_literal = isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str
                    )
                    anchored = is_literal and (
                        arg.value.endswith("/")
                        if meth == "startswith"
                        else arg.value.startswith("/")
                    )
                    if not anchored:
                        dyn = "dynamic value" if not is_literal else repr(arg.value)
                        yield ctx.finding(
                            "gauge-keys",
                            node,
                            f"{meth}({dyn}) on metric key {target.id!r} is "
                            f"not segment-anchored (PR-9: suffix matching "
                            f"missed mid-path replica segments); match "
                            f"against {target.id}.split(\"/\") or anchor the "
                            f"literal with '/'",
                        )
