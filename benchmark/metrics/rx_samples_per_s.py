"""Audio samples of all calls completed in the window over its seconds."""


def read(win):
    return win.calls * win.work["samples"] / win.seconds
