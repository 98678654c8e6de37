"""Host ms in the serving front's store round trip (span
``serving.lookup``: ``OnlineStore.lookup_encoded``, its routing, kernels
and copies) per GET (span ``store.get``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "serving.lookup", "host_s", per="store.get")
