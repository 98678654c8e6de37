"""Rule ``frozen-stats``: public stats surfaces return typed frozen objects.

History: PR 9 replaced the loose stats dicts threaded through the tree
(merge stats, lag, ship ledgers) with frozen dataclasses — ``MergeStats``,
``LagStats``/``PlaneLag``, ``ShipLedger``/``PlaneShip`` — because every
stringly-keyed dict consumer was one typo away from a silent ``KeyError``/
``None`` and none of it was discoverable.  This rule locks the refactor in:
a public ``core/`` function may not return a bare dict literal whose keys
reproduce the fields of an existing frozen stats dataclass — that is the
typed result, downgraded.

Mechanics: the project pre-pass collects every ``@dataclass(frozen=True)``
of the scanned files (on the default run, the port's tree) with its field
names.  A ``return {...}`` in a public
function (no leading underscore, not a serialization boundary —
``snapshot``/``to_dict``/``as_dict``/``to_json`` names are exempt, dicts
are their job) whose literal has >= 3 constant string keys ALL drawn from
one frozen dataclass's fields is flagged with the dataclass it shadows.
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import functions

_SERIALIZATION_NAMES = {"snapshot", "to_dict", "as_dict", "to_json", "as_json"}
_MIN_KEYS = 3


@registry.rule(
    "frozen-stats",
    scope=("src/repro_torch/core/*.py",),
    description="public core/ functions return the frozen stats dataclass, "
    "not a bare dict literal shadowing its fields (PR-9 "
    "typed-stats refactor)",
)
def check(ctx, project):
    if not project.frozen_dataclasses:
        return
    for fn in functions(ctx.tree):
        if fn.name.startswith("_") or fn.name in _SERIALIZATION_NAMES:
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Return) and isinstance(node.value, ast.Dict)):
                continue
            d = node.value
            keys = []
            for k in d.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.append(k.value)
                else:
                    keys = None  # dynamic/**-expanded keys: not a bare literal
                    break
            if not keys or len(keys) < _MIN_KEYS:
                continue
            keyset = set(keys)
            for name, fields in project.frozen_dataclasses.items():
                if keyset <= fields:
                    yield ctx.finding(
                        "frozen-stats",
                        node,
                        f"{fn.name}() returns a bare dict whose keys "
                        f"({', '.join(sorted(keyset))}) are fields of the "
                        f"frozen dataclass {name}; return {name} instead",
                    )
                    break
