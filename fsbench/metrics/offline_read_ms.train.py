"""Host ms in the offline store's read (span ``offline.read``:
``OfflineStore.read``, every chunk concatenated) per training step (span
``step.train``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "offline.read", "host_s", per="step.train")
