"""Host milliseconds a step in ``next()`` on the port's prefetch, the
window's mean, in a cell whose host paces the steps."""


def read(run):
    return run.span_mean_ms("prefetch_wait")
