"""The program's own spans and counters of a traced run
(``repro_torch.core.monitoring``: on while the window's profiler session
records), read out once a run for every reader.  A program without them
reads as None, and so does every metric that reads them."""

from __future__ import annotations

__all__ = ["counters", "per_call_ms"]


def _read(run) -> dict | None:
    if not hasattr(run, "program"):
        try:
            from repro_torch.core.monitoring import read_out
        except ImportError:
            run.program = None
        else:
            run.program = read_out()
    return run.program


def per_call_ms(run, name: str, field: str, per: str) -> float | None:
    """ms of ``field`` (``host_s`` or ``device_s``) summed over the spans
    ``name``, per span ``per``; None where either is missing or the field
    was not read (``device_s`` off the card)."""
    got = _read(run)
    if got is None:
        return None
    spans, divisor = got["spans"].get(name), got["spans"].get(per)
    if not spans or not divisor or spans[field] is None:
        return None
    return 1e3 * spans[field] / divisor["calls"]


def counters(run) -> dict:
    """The window's counters by name ({} where there are none)."""
    got = _read(run)
    return got["counters"] if got is not None else {}
