"""Share of the traced steps' wall time in which no kernel, copy or set
ran on the device, percent, in a cell whose host paces the steps."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
