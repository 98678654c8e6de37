"""Rule ``wire-format``: explicit endianness; every magic is dispatched.

History: the wire codec (PR 5) and the stream framing (PR 8) are the bytes
that cross machines.  ``struct`` formats without a byte-order prefix use
NATIVE order and alignment — a frame encoded on one architecture stops
decoding on another, and native alignment silently pads records.  Every
format string on the wire surface must therefore be little-endian-explicit
(``<``).  And every frame-kind magic (``MAGIC``/``CONTROL_MAGIC``/
``ACK_MAGIC``-style constants) must be dispatched by ``StreamDecoder`` —
a kind that encodes but never decodes is a frame the replica drops on the
floor after a resync (the decoder treats unknown magics as torn-stream
garbage, which is correct exactly because this rule guarantees there are
no legitimate unknown kinds).  The port's codec (``repro_torch.core.wire``,
its ``StreamDecoder``, and ``core.daemon``) puts the same bytes on the wire.
"""

from __future__ import annotations

import ast

from .. import registry
from ._ast_util import dotted_name

_STRUCT_FNS = {"pack", "unpack", "pack_into", "unpack_from", "calcsize", "iter_unpack"}


def _format_arg(call: ast.Call) -> ast.AST | None:
    """The format-string argument of a struct call, if this call carries
    one: ``struct.pack(fmt, ...)`` / ``struct.Struct(fmt)``.  Method calls
    on a prebuilt Struct instance (``_U32.pack(...)``) carry no format and
    are governed at their construction site."""
    fn = call.func
    name = dotted_name(fn)
    if name is not None and name.startswith("struct."):
        tail = name.rsplit(".", 1)[1]
        if tail in _STRUCT_FNS or tail == "Struct":
            return call.args[0] if call.args else None
    return None


def _format_is_little_endian(arg: ast.AST) -> bool | None:
    """True/False when the first character is statically known, else None."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.startswith("<")
    if isinstance(arg, ast.JoinedStr) and arg.values:
        head = arg.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value.startswith("<")
    return None


@registry.rule(
    "wire-format",
    scope=("src/repro_torch/core/wire.py", "src/repro_torch/core/daemon.py"),
    description="struct formats on the wire surface must be little-endian-"
    "explicit ('<'), and every frame kind magic must appear in "
    "StreamDecoder's dispatch",
)
def check(ctx, project):
    # -- endianness -----------------------------------------------------------
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fmt = _format_arg(node)
        if fmt is None:
            continue
        verdict = _format_is_little_endian(fmt)
        if verdict is False:
            yield ctx.finding(
                "wire-format",
                fmt,
                f"struct format {ast.unparse(fmt)} has no '<' byte-order "
                f"prefix — native order/alignment does not survive the "
                f"wire; make it little-endian-explicit",
            )
        elif verdict is None:
            yield ctx.finding(
                "wire-format",
                fmt,
                f"struct format {ast.unparse(fmt)} is dynamic and its "
                f"byte-order prefix cannot be checked; start it with a "
                f"literal '<'",
            )

    # -- magic dispatch (only meaningful where StreamDecoder lives) ----------
    magics: dict[str, ast.Assign] = {}
    tuples: dict[str, list[str]] = {}
    decoder: ast.ClassDef | None = None
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if "MAGIC" in tgt.id and isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, bytes
            ):
                magics[tgt.id] = node
            elif isinstance(node.value, (ast.Tuple, ast.List)):
                names = [
                    e.id for e in node.value.elts if isinstance(e, ast.Name)
                ]
                if names:
                    tuples[tgt.id] = names
        elif isinstance(node, ast.ClassDef) and node.name == "StreamDecoder":
            decoder = node
    if decoder is None or not magics:
        return
    referenced = {
        n.id
        for n in ast.walk(decoder)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }
    # expand one level of indirection: a tuple of magics referenced by the
    # decoder (e.g. _STREAM_MAGICS) dispatches its members
    for tup, members in tuples.items():
        if tup in referenced:
            referenced.update(members)
    for name, assign in magics.items():
        if name not in referenced:
            yield ctx.finding(
                "wire-format",
                assign,
                f"frame kind magic {name} is never dispatched by "
                f"StreamDecoder — frames of this kind are dropped as torn-"
                f"stream garbage on the receive path; add it to the "
                f"decoder's dispatch (and its magic tuple)",
            )
