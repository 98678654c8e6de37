"""Device ms in RMSNorm (span ``norm``: every call, MLA's latent norms
included) per prefill forward (span ``step.prefill``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "norm", "device_s", per="step.prefill")
