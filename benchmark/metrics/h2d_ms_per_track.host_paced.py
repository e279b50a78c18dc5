"""Device milliseconds of host-to-device copies a traced track, in a cell
whose host paces the tracks, so the copy moves the window's rate."""

from benchmark import readers


def read(run):
    return readers.copy_ms_per_unit(run, "HtoD")
