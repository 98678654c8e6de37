"""Small shared AST helpers for the rule modules."""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.random.default_rng`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_attr(node: ast.AST) -> Optional[str]:
    """The last attribute segment of a call target (``x.y.pack`` -> ``pack``;
    bare ``pack`` -> ``pack``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def attr_root(node: ast.AST) -> Optional[str]:
    """The leftmost name of an attribute chain (``self.x.y`` -> ``self``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = (
            node.value
            if isinstance(node, (ast.Attribute, ast.Subscript))
            else node.func
        )
    if isinstance(node, ast.Name):
        return node.id
    return None


def functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def statements_in_order(fn: ast.FunctionDef) -> list[ast.stmt]:
    """Every statement lexically inside ``fn`` (excluding nested function
    bodies), in source order — the linear approximation the local dataflow
    rules (aliasing) walk."""
    out: list[ast.stmt] = []

    def visit(body: list[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            out.append(stmt)
            for field in ("body", "orelse", "finalbody"):
                visit(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                visit(h.body)

    visit(fn.body)
    return sorted(out, key=lambda s: (s.lineno, s.col_offset))


def names_loaded(node: ast.AST) -> set[str]:
    return {
        n.id
        for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def names_stored(stmt: ast.stmt) -> set[str]:
    return {
        n.id
        for n in ast.walk(stmt)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
    }
