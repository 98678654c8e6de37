"""Share of the MoE expert buffer's slots that hold a token over the
window, in %: assignments kept (counter ``moe.kept``) over slots (counter
``moe.slots``, groups x experts x capacity); at most 100 / capacity factor."""

from fsbench import program


def read(run):
    c = program.counters(run)
    if not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.kept"] / c["moe.slots"]
