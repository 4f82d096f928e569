"""Host ms an iteration waited for its batch over the measured window: the
benchmark's span around ``next()`` on the port's ``DeviceFeeder``, so the
input pipeline's lag behind the trainer."""

from portbench.readers import span_ms


def read(r):
    return span_ms(r, "data_wait")
