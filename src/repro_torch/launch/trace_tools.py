"""Dry-run record inspection: the counterpart of the JAX package's
``launch/hlo_tools.py``.

The JAX package reads the compiled HLO module's symbol table.  Here the
dry-run runs the step once under ``Recorder``, a ``TorchDispatchMode``
that sees every op a rank runs on its local shards (DTensor's own ops
are let through to DTensor, which runs them locally and issues the
collectives; its shape propagation under a fake mode is skipped, the
global-shape stand-ins it creates included): each op's
outputs, its bytes read and written and its FLOPs (``FlopCounterMode``'s
formulas, ``torch.utils.flop_counter.flop_registry``), and the operands of
every collective (``_c10d_functional`` and ``c10d`` ops).  That record is
the torch counterpart of the HLO symbol table, and ``launch/roofline.py``
reads the same record.

``top_tensors`` ranks the largest tensor shapes the step creates (the
closest thing to a buffer-assignment profile; it finds score matrices,
dispatch buffers and float32 optimizer temporaries).  ``collective_sites``
groups collectives by (kind, operand shape), so a collective inserted per
layer shows up as count = num_layers.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["Recorder", "collective_sites", "shape_str", "top_tensors"]

_DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16", torch.float64: "f64",
    torch.int64: "s64", torch.int32: "s32", torch.int16: "s16", torch.int8: "s8",
    torch.uint8: "u8", torch.bool: "pred",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def shape_str(t: torch.Tensor) -> str:
    """'bf16[128,512]', as HLO writes a shape."""
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Recorder(TorchDispatchMode):
    """Records the local ops of one device's step.  After the block:
    ``flops`` (FLOPs of the ops ``FlopCounterMode`` counts), ``bytes``
    (operand and output bytes of every op that is not a view), ``outputs``
    (a Counter of output shapes) and ``collectives`` (kind, op, operand
    shape and bytes of each)."""

    def __init__(self) -> None:
        super().__init__()
        from repro_torch.launch.roofline import COLLECTIVE_KINDS

        self._kinds = COLLECTIVE_KINDS
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.outputs: Counter = Counter()
        self.output_bytes: dict[str, int] = {}
        self.collectives: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, seen below
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        if (any(isinstance(a, FakeTensor) for a in ins)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None):
            # DTensor's shape propagation, not the step's work: its ops on
            # fake tensors, and the global-shape stand-ins it makes for them
            # (under its fake mode, from no tensor)
            return out
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = self._kinds.get(packet.__name__)
            if kind is not None:
                operands = [a for a in ins if a.numel()]
                self.collectives.append({
                    "kind": kind, "op": f"{func.namespace}.{packet.__name__}",
                    "shape": shape_str(operands[0]) if operands else "?",
                    "bytes": sum(_nbytes(a) for a in operands)})
            return out
        if not func.is_view:
            self.bytes += sum(_nbytes(a) for a in ins) + sum(_nbytes(o) for o in outs)
            for o in outs:
                s = shape_str(o)
                self.outputs[s] += 1
                self.output_bytes[s] = _nbytes(o)
        return out


def top_tensors(record: Recorder, k: int = 15) -> list[tuple[str, int, int]]:
    """[(shape_str, bytes, count)] for the k largest distinct output shapes."""
    ranked = sorted(((s, record.output_bytes[s], c) for s, c in record.outputs.items()),
                    key=lambda t: -t[1])
    return ranked[:k]


def collective_sites(record: Recorder, k: int = 15) -> list[dict]:
    """Collectives grouped by (kind, operand shape): count + total bytes."""
    groups: dict[tuple, dict] = defaultdict(lambda: {"count": 0, "bytes": 0, "op_names": set()})
    for c in record.collectives:
        g = groups[(c["kind"], c["shape"])]
        g["count"] += 1
        g["bytes"] += c["bytes"]
        g["op_names"].add(c["op"])
    out = [{"kind": key[0], "shape": key[1], "count": v["count"], "bytes": v["bytes"],
            "op_names": sorted(v["op_names"])[:4]} for key, v in groups.items()]
    return sorted(out, key=lambda d: -d["bytes"])[:k]
