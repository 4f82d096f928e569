"""The share of the trainer's gets from the input pipeline that found a
batch already waiting (the program's counters ``data.ready`` over
``data.get``, in ``Prefetcher.__next__``), over the traced stretch."""

from portbench import phases


def read(r):
    p = phases.of(r)
    return p.ratio_pct("data.ready", "data.get") if p else None
