"""The header a call, ms, from the program's span enc.header (self time):
header_and_main, build_tile, _leaf_deltas, byte_budget and the plans."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.header", "self_ns")
    return None if ns is None else ns / 1e6
