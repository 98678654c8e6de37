"""Rule ``format``: the executable slice of the ruff-format gate.

History: since PR 3 the CI workflow has declared ``ruff format --check``
over an ever-widening tree, but ruff cannot install in the build container,
so every PR verified the gate "best-effort" with hand-rolled approximations.
This tokenize-based probe EXECUTES the mechanically-checkable portion of
that gate everywhere Python runs.  The port holds its counterparts of the
trees the gate claims (``src/repro_torch/core``, ``kernels`` and
``models``) to it:

* line length <= 88 (``pyproject.toml`` ``line-length``) — stricter than
  the formatter itself, which leaves long comments/strings alone; the
  pragma escape exists for the rare unsplittable literal;
* double quotes for string literals (``quote-style = "double"``), except
  strings whose body contains a double quote — ruff keeps single quotes
  there to avoid escaping;
* no trailing whitespace.

An f-string is judged whole, by its own quote.  Up to Python 3.11 it is one
STRING token.  From 3.12 (PEP 701) it tokenizes as ``FSTRING_START``, its
literal parts and replacement fields, then ``FSTRING_END``; the JAX
package's copy of this rule reads only STRING tokens, so under 3.12 it flags
the ``'key'`` inside ``f"{c['arch']}"`` and never sees a single-quoted
``f'...'``.  Here the STRING tokens nested in an f-string are skipped and
the f-string's quote is read from its ``FSTRING_START``, which gives the
findings that rule gives on 3.10.
"""

from __future__ import annotations

import tokenize

from .. import registry

_MAX_LEN = 88
_PREFIX_CHARS = "rbfuRBFU"
#: absent before Python 3.12, where an f-string is a single STRING token
_FSTRING_START = getattr(tokenize, "FSTRING_START", None)
_FSTRING_END = getattr(tokenize, "FSTRING_END", None)


@registry.rule(
    "format",
    scope=(
        "src/repro_torch/core/*.py",
        "src/repro_torch/kernels/*.py",
        "src/repro_torch/kernels/*/*.py",
        "src/repro_torch/models/*.py",
    ),
    description="executed format gate for the port's counterparts of the "
    "ruff-format-claimed trees: <=88-char lines, double quotes, no trailing "
    "whitespace",
)
def check(ctx, project):
    for i, line in enumerate(ctx.lines, start=1):
        if len(line) > _MAX_LEN:
            yield ctx.finding(
                "format",
                i,
                f"line is {len(line)} chars (> {_MAX_LEN}); wrap it "
                f"(ruff line-length)",
                col=_MAX_LEN,
            )
        if line != line.rstrip():
            yield ctx.finding(
                "format",
                i,
                "trailing whitespace",
                col=len(line.rstrip()),
            )
    for start, text in _string_literals(ctx):
        body = text.lstrip(_PREFIX_CHARS)
        if body.startswith("'"):
            quote = "'''" if body.startswith("'''") else "'"
            inner = body[len(quote) : -len(quote)]
            if '"' not in inner:
                yield ctx.finding(
                    "format",
                    start[0],
                    "single-quoted string; the format gate's quote-style "
                    'is "double"',
                    col=start[1],
                )


def _string_literals(ctx):
    """(start, source text) of every outermost string literal: each STRING
    token outside an f-string, and each f-string whole, from its
    ``FSTRING_START`` to its matching ``FSTRING_END``."""
    depth = 0
    opened = None
    for tok in ctx.tokens:
        if tok.type == _FSTRING_START:
            if depth == 0:
                opened = tok.start
            depth += 1
        elif tok.type == _FSTRING_END:
            depth -= 1
            if depth == 0:
                yield opened, _source_span(ctx.lines, opened, tok.end)
        elif tok.type == tokenize.STRING and depth == 0:
            yield tok.start, tok.string


def _source_span(lines, start, end) -> str:
    (r0, c0), (r1, c1) = start, end
    if r0 == r1:
        return lines[r0 - 1][c0:c1]
    parts = [lines[r0 - 1][c0:], *lines[r0 : r1 - 1], lines[r1 - 1][:c1]]
    return "\n".join(parts)
