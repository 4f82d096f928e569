"""Host ms an iteration in the optimizer and the EMA (the program's spans
``g_step.adam``, ``d_step.adam``, ``ema``: their ``_foreach`` launches),
over the traced stretch."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.host_ms(phases.OPTIMIZER) if p else None
