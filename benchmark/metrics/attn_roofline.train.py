"""The attention kernels' (B5, forward and backward) roofline bound over
their device time in the traced steps, percent."""

from benchmark import readers


def read(run):
    return readers.attention_share(run, backward=True)
