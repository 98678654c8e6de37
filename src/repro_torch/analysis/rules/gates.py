"""Rule ``vacuous-gate``: a CI gate that cannot fail is worse than no gate.

History: PR 8 found the standalone bench-regression CI step passing
vacuously whenever ``results/bench_fast.json`` was missing — the exact
failure mode (bench smoke silently dead upstream) the gate existed to
catch — and the upload step was configured to ignore the same absence.
MLOps mapping studies call this the declared-vs-executed quality-gate gap;
this rule closes the Python side of it for the port's gate surfaces (its
``scripts/*_torch.py`` and ``chip_smoke.py``, whose every phase must fail
the run when its check fails, never catch the failure and exit 0):

* an ``except`` that swallows broadly — bare / ``Exception`` /
  ``BaseException`` with a body that is only ``pass`` — hides the crash
  that should have failed the gate (narrow except-pass is fine: killing an
  already-dead pid legitimately ignores ``ProcessLookupError``);
* ``continue`` or ``return True``/``return 0`` as the entire body of ANY
  except handler silently skips the section that just failed;
* ``return True`` guarded by a file-absence test (``.exists()`` /
  ``.is_file()`` / ``os.path.exists``/``isfile``) passes the gate exactly
  when its input is missing;
* ``assert <constant>`` asserts nothing.
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import terminal_attr

_BROAD = {"Exception", "BaseException"}
_EXISTENCE = {"exists", "is_file", "isfile", "is_dir", "isdir"}


def _handler_types(h: ast.ExceptHandler) -> list[str]:
    t = h.type
    if t is None:
        return ["<bare>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return [terminal_attr(e) or "<expr>" for e in elts]


def _only(body: list[ast.stmt], kind) -> ast.stmt | None:
    real = [s for s in body if not _is_docstring(s)]
    if len(real) == 1 and isinstance(real[0], kind):
        return real[0]
    return None


def _is_docstring(s: ast.stmt) -> bool:
    return (
        isinstance(s, ast.Expr)
        and isinstance(s.value, ast.Constant)
        and isinstance(s.value.value, str)
    )


def _is_vacuous_return(s: ast.stmt) -> bool:
    if not (isinstance(s, ast.Return) and isinstance(s.value, ast.Constant)):
        return False
    v = s.value.value
    # NOT `v in (True, 0)`: False == 0, and `return False` is a loud failure
    return v is True or (type(v) is int and v == 0)


def _mentions_existence_check(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and terminal_attr(n.func) in _EXISTENCE:
            return True
    return False


@registry.rule(
    "vacuous-gate",
    scope=("scripts/*_torch.py", "chip_smoke.py"),
    description="gate code must fail loudly: no swallow-and-continue "
    "excepts, no pass-on-missing-artifact, no constant asserts "
    "(the PR-8 vacuous bench-regression step)",
)
def check(ctx, project):
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler):
            types = _handler_types(node)
            swallowed = _only(node.body, ast.Pass)
            if swallowed is not None and (set(types) & _BROAD or "<bare>" in types):
                yield ctx.finding(
                    "vacuous-gate",
                    node,
                    f"except {'/'.join(types)} swallowed with bare 'pass' — "
                    f"the crash this hides is exactly what the gate should "
                    f"report; narrow the exception or handle it loudly",
                )
            skipper = _only(node.body, (ast.Continue, ast.Return))
            if skipper is not None and (
                isinstance(skipper, ast.Continue) or _is_vacuous_return(skipper)
            ):
                what = (
                    "continue"
                    if isinstance(skipper, ast.Continue)
                    else f"return {skipper.value.value!r}"
                )
                yield ctx.finding(
                    "vacuous-gate",
                    node,
                    f"except {'/'.join(types)} answers failure with "
                    f"'{what}' — the gated section is silently skipped on "
                    f"error; record a failure instead",
                )
        elif isinstance(node, ast.If) and _mentions_existence_check(node.test):
            for branch in (node.body, node.orelse):
                for s in branch:
                    if _is_vacuous_return(s):
                        yield ctx.finding(
                            "vacuous-gate",
                            s,
                            "a file-existence test guards a success return — "
                            "a missing artifact makes this gate pass "
                            "vacuously; fail loudly when the input is absent",
                        )
        elif isinstance(node, ast.Assert):
            t = node.test
            if isinstance(t, ast.Constant) or (
                isinstance(t, ast.Tuple) and t.elts
            ):
                yield ctx.finding(
                    "vacuous-gate",
                    node,
                    "assert on a constant can never fail (or always fails); "
                    "assert the measured quantity instead",
                )
