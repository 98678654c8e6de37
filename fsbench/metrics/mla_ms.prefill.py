"""Device ms in multi-head latent attention (span ``mla``: projections,
latent norms, float32 attention) per prefill forward (span
``step.prefill``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "mla", "device_s", per="step.prefill")
