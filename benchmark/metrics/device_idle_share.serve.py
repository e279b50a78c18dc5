"""Share of the traced tracks' wall time in which no kernel, copy or set
ran on the device, percent."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
