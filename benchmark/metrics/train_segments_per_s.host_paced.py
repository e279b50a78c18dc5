"""Segments trained in the traced run's window over its wall seconds, in
a cell whose host paces the steps, so that the rate follows the host's
speed from run to run."""


def read(run):
    w = run.window
    return w["segments"] / w["wall_s"] if "segments" in w else None
