"""Device ms in the optimizer's update (span ``step.optimizer``: AdamW
with its clip) per training step (span ``step.train``)."""

from fsbench import program


def read(run):
    return program.per_call_ms(run, "step.optimizer", "device_s", per="step.train")
