"""The codestreams' assembly a call, ms, from the program's span
enc.finalize (self time): SOT, SOD and body joins and every frame's
_finalize_codestream."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.finalize", "self_ns")
    return None if ns is None else ns / 1e6
