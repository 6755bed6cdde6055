"""encode_batch's self time a call, ms, from the program's span enc.batch:
its host time that no span inside it covers (the steps between the header,
the stacking, the device program, the fetch, Tier-2 and the joins)."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.batch", "self_ns")
    return None if ns is None else ns / 1e6
