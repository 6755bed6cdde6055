"""The frames' stacking into one host batch a call, ms, from the program's
span enc.stack (self time)."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.stack", "self_ns")
    return None if ns is None else ns / 1e6
