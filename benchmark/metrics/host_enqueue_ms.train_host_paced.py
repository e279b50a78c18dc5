"""Host milliseconds a step inside the train step's call (its enqueue),
the window's mean, in a cell whose host paces the steps."""


def read(run):
    return run.span_mean_ms("step")
