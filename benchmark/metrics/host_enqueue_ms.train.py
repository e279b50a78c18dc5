"""Host milliseconds a step inside the train step's call (its enqueue),
the window's mean; near the step time, the host paces the step."""


def read(run):
    return run.span_mean_ms("step")
