"""Forward calls of the Transcriber's model a track in the window
(its bucketing: full batches, then the smallest buckets that fit)."""


def read(run):
    w = run.window
    return w["forward_calls"] / w["tracks"] if w.get("tracks") else None
