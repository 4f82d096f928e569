"""Device ms an iteration in remat's recomputes (the program's span
``remat.recompute``, opened on autograd's device thread), over the traced
stretch: the stream's time between each span's two CUDA events, on the
events' own clock (``portbench/phases.py``), so it needs no map onto the
trace's kernel times, which jump by milliseconds in b32's 16-s stretch;
what idle falls inside counts (1.0-1.4% over the recompute's busy time
there). Nothing where no block is checkpointed."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.window_ms(phases.RECOMPUTE) if p else None
