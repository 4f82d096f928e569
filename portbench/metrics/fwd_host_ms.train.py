"""Host ms an iteration in the train step's forward phases (the program's
spans ``g_step.forward``, ``d_step.fake``, ``d_step.forward``), each less
its child spans on its thread (R1's gradient), over the traced stretch:
the Python and the launches of the forwards and the losses."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.host_ms(phases.FORWARD, self_time=True) if p else None
