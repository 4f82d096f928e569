"""Host ms an iteration the step's thread spends in the backward phases
(the program's spans ``g_step.backward``, ``d_step.backward``, ``r1.grad``),
over the traced stretch: on the card that thread waits there while
autograd's device thread launches the backward's kernels."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.host_ms(phases.BACKWARD_HOST) if p else None
