"""Output tokens made inside the window, over the window's seconds."""


def read(run):
    w = run.window
    return w.emitted / w.seconds
