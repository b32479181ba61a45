"""Seconds from the process's start to the window's start."""


def read(win):
    return win.setup_s
