"""Nominal training operations of the traced steps over their device
busy seconds, as a share of the bf16 dense peak (989 TFLOP/s at 700 W),
percent: the whole step's share of the peak by the card's own time."""

from benchmark import readers


def read(run):
    return readers.device_mfu(run)
