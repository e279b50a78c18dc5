"""Forward calls of the Transcriber's model a chunk fed in the window (a
live session's feed runs the windows it completes as one call, and the
flush its last)."""


def read(run):
    w = run.window
    chunks = len(w.get("chunk_s") or ())
    return w["forward_calls"] / chunks if chunks else None
