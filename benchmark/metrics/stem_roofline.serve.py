"""The stem tail forward kernel's (B2 stem_fwd) roofline bound over its
device time in the traced tracks, percent."""

from benchmark import readers


def read(run):
    return readers.stem_share(run, backward=False)
