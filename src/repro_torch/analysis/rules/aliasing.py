"""Rule ``aliasing``: long-lived ``self.*`` state must not alias caller arrays.

History: PR 5.  ``ReplicationLog.append`` stored ``np.asarray(keys, ...)``
in the logged batch — ``asarray`` is a no-copy view when dtype already
matches, so the log aliased the publisher's LIVE merge buffers, and a
publisher reusing its arrays rewrote history that replicas had yet to
drain.  The fix (``_frozen_copy``) copies and sets ``writeable=False``.
This rule is that bug as an invariant on the port's retention surfaces
(``repro_torch.core.replication``'s log and ``core.serving``'s
queues/cache, host numpy code as in the JAX package): an array that flows
into ``self.*`` state — directly, or via an object appended to a ``self.*``
container — must be defensively copied, not ``asarray``'d, and never a bare
parameter store.

Detection is a linear per-function taint walk (source order, one pass —
deliberately simple; the suppression pragma exists for code the walk
misjudges, and the fixture suite pins the PR-5 shape verbatim):

* taint sources: ``np.asarray`` / ``np.frombuffer`` / ``np.ascontiguousarray``
  calls (alias-on-match constructors), and function parameters annotated as
  arrays (``np.ndarray`` / ``ArrayLike``);
* taint flows through assignment when the RHS contains a tainted name or a
  taint source (one constructor call deep — the ``ReplicatedBatch(keys=
  np.asarray(...))`` shape), and clears when a name is rebound clean;
* sinks: ``self.X = <tainted>``, ``self....append/add/appendleft(<tainted>)``,
  ``self....[k] = <tainted>``.
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import (
    attr_root,
    dotted_name,
    functions,
    names_loaded,
    names_stored,
    statements_in_order,
    terminal_attr,
)

_ALIAS_CTORS = {
    "np.asarray",
    "numpy.asarray",
    "np.frombuffer",
    "numpy.frombuffer",
    "np.ascontiguousarray",
    "numpy.ascontiguousarray",
}
_ARRAYISH_ANNOTATIONS = ("ndarray", "ArrayLike")
_APPEND_METHODS = {"append", "appendleft", "add", "insert"}


def _alias_calls(node: ast.AST) -> list[ast.Call]:
    return [
        n
        for n in ast.walk(node)
        if isinstance(n, ast.Call) and dotted_name(n.func) in _ALIAS_CTORS
    ]


def _is_self_target(node: ast.AST) -> bool:
    """``self.x``, ``self.x.y``, ``self.x[k]`` as an assignment target."""
    if isinstance(node, (ast.Attribute, ast.Subscript)):
        return attr_root(node) == "self"
    return False


def _array_params(fn: ast.FunctionDef) -> set[str]:
    out = set()
    args = fn.args
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        ann = a.annotation
        if ann is None:
            continue
        text = ast.unparse(ann)
        if any(tag in text for tag in _ARRAYISH_ANNOTATIONS):
            out.add(a.arg)
    return out


@registry.rule(
    "aliasing",
    scope=(
        "src/repro_torch/core/replication.py",
        "src/repro_torch/core/serving.py",
    ),
    description="retained self.* state must copy caller arrays, not alias "
    "them via np.asarray / bare parameter stores (the PR-5 "
    "ReplicationLog.append bug)",
)
def check(ctx, project):
    for fn in functions(ctx.tree):
        arr_params = _array_params(fn)
        tainted: dict[str, str] = {}  # name -> why
        for p in arr_params:
            tainted[p] = f"parameter {p!r} (array-annotated caller buffer)"
        for stmt in statements_in_order(fn):
            # -- sinks first: flag uses, then update taint for this stmt ----
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                value = stmt.value
                if value is not None:
                    for tgt in targets:
                        if not _is_self_target(tgt):
                            continue
                        for call in _alias_calls(value):
                            yield ctx.finding(
                                "aliasing",
                                call,
                                f"{dotted_name(call.func)} result stored in "
                                f"long-lived {ast.unparse(tgt)} aliases the "
                                f"caller's buffer; copy it (np.array(..., "
                                f"copy=True) / a frozen-copy constructor)",
                            )
                        why = _tainted_reason(value, tainted)
                        if not _alias_calls(value) and why:
                            yield ctx.finding(
                                "aliasing",
                                stmt,
                                f"{ast.unparse(tgt)} retains {why} without a "
                                f"defensive copy; the caller can mutate it "
                                f"after publish",
                            )
            elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                call = stmt.value
                meth = terminal_attr(call.func)
                if (
                    meth in _APPEND_METHODS
                    and isinstance(call.func, ast.Attribute)
                    and attr_root(call.func.value) == "self"
                ):
                    for a in call.args:
                        why = _tainted_reason(a, tainted)
                        if why:
                            yield ctx.finding(
                                "aliasing",
                                call,
                                f"self-container .{meth}() retains {why} "
                                f"without a defensive copy; the caller can "
                                f"mutate it after publish",
                            )
            # -- taint update ----------------------------------------------
            if isinstance(stmt, ast.Assign) and stmt.value is not None:
                reason = _taint_of(stmt.value, tainted)
                for tgt in stmt.targets:
                    for name in _simple_store_names(tgt):
                        if reason:
                            tainted[name] = reason
                        else:
                            tainted.pop(name, None)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                reason = _taint_of(stmt.value, tainted)
                for name in _simple_store_names(stmt.target):
                    if reason:
                        tainted[name] = reason
                    else:
                        tainted.pop(name, None)
            else:
                for name in names_stored(stmt):
                    # loop vars / with targets / etc.: conservatively clean
                    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        tainted.pop(name, None)


def _simple_store_names(tgt: ast.AST) -> list[str]:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [e.id for e in tgt.elts if isinstance(e, ast.Name)]
    return []


#: calls that reduce an array to a scalar/fresh object — taint stops here
_SCALAR_FNS = {"len", "int", "float", "bool", "str", "sum", "abs", "repr", "round"}


def _taint_of(value: ast.AST, tainted: dict[str, str]) -> str | None:
    """Why the RHS is tainted, or None.  ``.copy()`` anywhere in the RHS is
    treated as the cleansing act (np.array() copies by default too)."""
    text = ast.unparse(value)
    if ".copy()" in text or "copy=True" in text or "_frozen_copy" in text:
        return None
    calls = _alias_calls(value)
    if calls:
        return f"an un-copied {dotted_name(calls[0].func)} view"
    return _tainted_reason(value, tainted)


def _tainted_reason(node: ast.AST, tainted: dict[str, str]) -> str | None:
    """Taint propagates only through VALUE-PRESERVING expression shapes — a
    bare name, a view of it (subscript/attribute), a container literal
    holding it, or a call retaining it as a direct argument.  Arithmetic,
    comparisons, and scalar builtins (``len(ids)``) produce fresh objects
    and stop the taint."""
    if isinstance(node, ast.Name):
        return tainted.get(node.id)
    if isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
        return _tainted_reason(node.value, tainted)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for el in node.elts:
            why = _tainted_reason(el, tainted)
            if why:
                return why
        return None
    if isinstance(node, ast.Dict):
        for v in node.values:
            why = _tainted_reason(v, tainted)
            if why:
                return why
        return None
    if isinstance(node, ast.IfExp):
        return _tainted_reason(node.body, tainted) or _tainted_reason(
            node.orelse, tainted
        )
    if isinstance(node, ast.NamedExpr):
        return _tainted_reason(node.value, tainted)
    if isinstance(node, ast.Call):
        fn = terminal_attr(node.func)
        if fn in _SCALAR_FNS:
            return None
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            why = _tainted_reason(a, tainted)
            if why:
                return why
    return None
