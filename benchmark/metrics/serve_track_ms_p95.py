"""95th percentile of the window's track times (``transcribe`` call to
host frets), milliseconds, over every track."""

from benchmark import readers


def read(run):
    return readers.track_p95_ms(run)
