"""Host milliseconds a step waiting on ``device_prefetch``'s ``next()``,
the window's mean."""


def read(run):
    return run.span_mean_ms("prefetch_wait")
