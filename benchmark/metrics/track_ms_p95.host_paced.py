"""95th percentile of the traced run's window's track times, milliseconds,
in a cell whose card sits idle most of the window, so that the host paces
each track and its tail swings with the host's speed."""

from benchmark import readers


def read(run):
    return readers.track_p95_ms(run)
