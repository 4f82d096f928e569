"""Device ms an iteration of the kernels launched in the train step's
backward phases (the program's spans ``g_step.backward``,
``d_step.backward``, ``r1.grad`` and remat's ``remat.recompute``), over the
traced stretch, each kernel given to its innermost span on the device's
timeline (``portbench/phases.py``)."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.device_ms(phases.BACKWARD) if p else None
