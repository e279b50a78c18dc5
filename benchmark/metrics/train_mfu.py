"""Nominal training operations of the window's segments over its seconds,
as a share of the bf16 dense peak (989 TFLOP/s at 700 W), percent."""

from benchmark import readers


def read(run):
    return readers.mfu(run, train=True)
