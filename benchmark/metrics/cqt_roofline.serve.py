"""B1's ``default``-tier kernels' (cqt_mma_kernel, cqt_db_kernel) roofline
bound over their device time in the traced tracks, percent."""

from benchmark import readers


def read(run):
    return readers.cqt_share(run, backward=False)
