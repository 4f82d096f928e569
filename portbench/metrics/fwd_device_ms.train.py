"""Device ms an iteration of the kernels launched in the train step's
forward phases (the program's spans ``g_step.forward``, ``d_step.fake``,
``d_step.forward``; R1's gradient inside the last is backward), over the
traced stretch: each kernel goes to the innermost span whose CUDA events
hold it on the device's timeline (``portbench/phases.py``)."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.device_ms(phases.FORWARD) if p else None
