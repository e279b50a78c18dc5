"""Device microseconds a trained segment: the union of the kernel, copy
and set intervals of a traced stretch of the window's steps (taken after
the window in a ``--trace 0`` run) over the segments those steps train.
What a segment costs the card where the host paces the step, so that the
window's wall rate follows the host's speed."""

from benchmark import readers


def read(run):
    return readers.device_us_per_segment(run)
