"""Device milliseconds of host-to-device copies a traced track."""

from benchmark import readers


def read(run):
    return readers.copy_ms_per_unit(run, "HtoD")
