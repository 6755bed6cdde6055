"""Process start to the first timed call, s: imports, CUDA init, the
builds on a checkout's first run, the pool made from the seed, the
operation's own set-up and the warm-up of the cell's shapes."""


def read(w):
    return w.setup_s
