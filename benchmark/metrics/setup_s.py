"""Set-up seconds: process start to the window's first step or track."""


def read(run):
    return run.setup_s
