"""Host ms a batch in ``to_unit``'s copy to the host (the program's span
``to_unit.copy``), over the traced stretch: the copy to pageable memory
waits for the generator's kernels, then copies."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.host_ms(("to_unit.copy",)) if p else None
