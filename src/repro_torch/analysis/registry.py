"""Rule registry: names, scopes, and the decorator that wires a checker in.

A rule is a plain function ``check(ctx: FileContext, project: ProjectContext)
-> Iterable[Finding]`` plus metadata: a stable short name (what suppressions
and the baseline refer to), a one-line description (what ``--list-rules``
prints), and a SCOPE — repo-relative glob patterns naming the only files the
rule runs on.  Scoping is the precision lever: every rule here encodes an
invariant of a specific subsystem of the port (the deterministic-replay
surface, the wire codec, the kernel wrappers, the gate scripts), and running
it outside that subsystem would manufacture false positives, so the default
run applies each rule exactly where its invariant holds.
``repro_torch.analysis.engine`` can override scoping for fixture tests
(``ignore_scope=True``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Callable, Iterable, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .engine import FileContext, Finding, ProjectContext

CheckFn = Callable[["FileContext", "ProjectContext"], Iterable["Finding"]]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered invariant checker."""

    name: str
    description: str
    scope: tuple[str, ...]
    check: CheckFn

    def applies_to(self, rel_path: str) -> bool:
        return any(fnmatch.fnmatch(rel_path, pat) for pat in self.scope)


#: name -> Rule; populated at import time by the ``rule`` decorator below.
RULES: dict[str, Rule] = {}


def rule(name: str, *, scope: tuple[str, ...], description: str):
    """Register ``fn`` as the checker for rule ``name``.

    ``scope`` patterns are repo-relative posix paths matched with fnmatch
    (``src/repro_torch/core/wire.py``, ``scripts/*_torch.py``,
    ``src/repro_torch/kernels/*``); fnmatch's ``*`` also matches ``/``.
    """

    def deco(fn: CheckFn) -> CheckFn:
        if name in RULES:
            raise ValueError(f"duplicate rule name: {name}")
        RULES[name] = Rule(
            name=name, description=description, scope=scope, check=fn
        )
        return fn

    return deco


def active_rules(select: Iterable[str] | None = None) -> list[Rule]:
    """The rule set for one run, in registration order.

    ``select`` (names) narrows the set; unknown names raise so a typo in
    ``--select`` cannot silently skip the check it meant to run.
    """
    if select is None:
        return list(RULES.values())
    chosen = []
    for name in select:
        if name not in RULES:
            known = ", ".join(sorted(RULES))
            raise KeyError(f"unknown rule {name!r} (known: {known})")
        chosen.append(RULES[name])
    return chosen
