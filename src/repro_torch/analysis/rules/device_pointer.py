"""Rule ``device-pointer``: a raw device address is taken of a named tensor.

The port's counterpart of the JAX package's ``donation`` rule.  There, PR 2
made device memory the source of truth and jitted the online-merge scatter
with ``donate_argnums``; the rule keeps a donated buffer from being touched
after XLA took its memory.  Torch has no donation: in the port, device
memory passes to a hand-written kernel as a raw ``tensor.data_ptr()``
integer in a ctypes launch, and nothing ties the integer to the tensor's
lifetime.  So the hazard moves to where the address is taken.

``x.contiguous().data_ptr()``, ``t.to(dtype).data_ptr()`` or
``torch.empty(n).data_ptr()`` take the address of a temporary.  The tensor
is freed as soon as ``.data_ptr()`` returns — before the launch is even
called — and the caching allocator hands its block to the next allocation:
an output allocated in a later argument, or any tensor made before the
launch, gets the same address, and the work queued for it overwrites the
data the kernel was given.  The launch then reads garbage and nothing
raises.

The invariant, for the device plane (``core/online_store.py`` and the
kernel wrappers under ``kernels/``, the surface the donation rule guards):
every ``.data_ptr()`` is taken of a plain name bound in the enclosing
function — a parameter, an assignment, a loop or ``with`` target — whose
reference keeps the storage alive until the name is rebound or the function
returns.  A call's, subscript's or attribute's result is flagged, and so is
a name the function does not bind (a global or a closure variable, whose
lifetime the function does not hold).
"""

from __future__ import annotations

import ast

from .. import registry

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_KINDS = {
    ast.Call: "a call's result",
    ast.Subscript: "a subscript",
    ast.Attribute: "an attribute",
}


@registry.rule(
    "device-pointer",
    scope=(
        "src/repro_torch/core/online_store.py",
        "src/repro_torch/kernels/*/*.py",
        "src/repro_torch/kernels/*.py",
    ),
    description="every .data_ptr() handed to a kernel is taken of a plain "
    "name bound in the enclosing function, never of a temporary the "
    "allocator frees before the launch (the port's counterpart of donation)",
)
def check(ctx, project):
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    bound_in: dict[ast.AST, set[str]] = {}
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "data_ptr"
            and not node.args
            and not node.keywords
        ):
            continue
        recv = node.func.value
        text = ast.unparse(recv)
        if not isinstance(recv, ast.Name):
            kind = _KINDS.get(type(recv), "an expression")
            yield ctx.finding(
                "device-pointer",
                node,
                f"{text}.data_ptr() takes the address of {kind}, which may "
                f"be a temporary: it is freed as soon as data_ptr() returns "
                f"and the allocator can hand its block to the next allocation "
                f"before the kernel reads it; bind the tensor to a local name "
                f"first",
            )
            continue
        scope = _enclosing_scope(node, parents) or ctx.tree
        if scope not in bound_in:
            bound_in[scope] = _bound_names(scope)
        if recv.id not in bound_in[scope]:
            yield ctx.finding(
                "device-pointer",
                node,
                f"{text}.data_ptr(): {text!r} is not bound in the enclosing "
                f"function, which then does not hold the tensor alive "
                f"through the launch; bind it to a local name first",
            )


def _enclosing_scope(node: ast.AST, parents: dict) -> ast.AST | None:
    node = parents.get(node)
    while node is not None and not isinstance(node, _SCOPES):
        node = parents.get(node)
    return node


def _bound_names(scope: ast.AST) -> set[str]:
    """Names ``scope`` binds: its parameters and every name stored in its
    body, nested function bodies excluded (their names are theirs)."""
    out: set[str] = set()
    if isinstance(scope, _SCOPES):
        a = scope.args
        params = [*a.posonlyargs, *a.args, *a.kwonlyargs, a.vararg, a.kwarg]
        out.update(p.arg for p in params if p is not None)
        body = [scope.body] if isinstance(scope, ast.Lambda) else scope.body
    else:
        body = scope.body
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((al.asname or al.name).split(".")[0] for al in node.names)
        stack.extend(ast.iter_child_nodes(node))
    return out
