"""Pixels decoded in the window over the window's wall, Mpix/s: every
call's pixels (each once, whatever its components) and all the time."""


def read(w):
    return w.pixels / 1e6 / w.window_s
