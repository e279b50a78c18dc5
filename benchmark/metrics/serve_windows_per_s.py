"""0.2 s windows of every track completed in the window over its wall
seconds."""


def read(run):
    w = run.window
    return w["windows"] / w["wall_s"] if "windows" in w else None
