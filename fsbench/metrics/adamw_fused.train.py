"""Share of the parameters AdamW's hand-written kernel updated over the
window, in %: counter ``adamw.fused`` over counter ``adamw.elems`` (every
parameter), both counted by ``optim/adamw.py`` ``update``.  None where the
program counts neither, or where the step ran off the card (``adamw.fused``
is counted on a card only)."""

from fsbench import program


def read(run):
    c = program.counters(run)
    if "adamw.fused" not in c or not c.get("adamw.elems"):
        return None
    return 100.0 * c["adamw.fused"] / c["adamw.elems"]
