"""Host ms an iteration spent in ``Trainer.train_iteration`` over the
measured window: the benchmark's span around the call, so the enqueue of
the step's kernels and the Python around it."""

from portbench.readers import span_ms


def read(r):
    return span_ms(r, "step")
