"""Device ms in the MoE layers (span ``moe``: routing, dispatch, experts,
combine, shared experts) per prefill forward (span ``step.prefill``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "moe", "device_s", per="step.prefill")
