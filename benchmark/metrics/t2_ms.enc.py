"""Host Tier-2 a call, ms: fused_encode.t2_bodies, the native
ht_t2_encode_frames with the pool's placement, as fetch_bodies calls it."""
STAGES = [("models.fused_encode", "t2_bodies", "native Tier-2")]


def read(t):
    return t.incl_ms("native Tier-2") / t.calls
