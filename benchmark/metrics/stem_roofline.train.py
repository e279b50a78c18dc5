"""The stem tail kernels' (B2 stem_stats, stem_fwd, stem_bwd) roofline
bound over their device time in the traced steps, percent."""

from benchmark import readers


def read(run):
    return readers.stem_share(run, backward=True)
