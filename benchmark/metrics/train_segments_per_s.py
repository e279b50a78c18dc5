"""Segments trained in the window over its wall seconds (the window ends
with a device synchronize)."""


def read(run):
    w = run.window
    return w["segments"] / w["wall_s"] if "segments" in w else None
