"""Device ms an iteration of the kernels launched by the optimizer and the
EMA (the program's spans ``g_step.adam``, ``d_step.adam``, ``ema``), over
the traced stretch, each kernel given to its innermost span on the device's
timeline (``portbench/phases.py``)."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.device_ms(phases.OPTIMIZER) if p else None
