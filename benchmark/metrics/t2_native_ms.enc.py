"""The native Tier-2 call alone a call, ms, from the program's span
enc.t2.native (inclusive): lib.ht_t2_encode_frames, without the Python
around it that t2_ms.enc holds."""
from benchmark.spans import per_call


def read(t):
    ns = per_call("enc.t2.native", "incl_ns")
    return None if ns is None else ns / 1e6
