"""The attention forward kernel's (B5) roofline bound over its device
time in the traced tracks, percent."""

from benchmark import readers


def read(run):
    return readers.attention_share(run, backward=False)
