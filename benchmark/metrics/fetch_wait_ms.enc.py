"""How long the host waits for the device program a call, ms, from the
program's span enc.fetch.wait (inclusive): fetch_pool's read of the word
totals, which returns when the program has run."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.fetch.wait", "incl_ns")
    return None if ns is None else ns / 1e6
