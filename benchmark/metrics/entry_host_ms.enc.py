"""encode_batch's own host time a call, ms: its wall less the stages
below it (the device program with its upload, the fetch of the pool,
native Tier-2); what is left is header_and_main, the frames' stacking and
_finalize_codestream."""
STAGES = [("models.encoder", "encode_batch", "encode_batch"),
          ("models.fused_encode", "fused_encode_chunk", "device program",
           True),
          ("models.fused_encode", "fetch_pool", "fetch", True),
          ("models.fused_encode", "t2_bodies", "native Tier-2")]


def read(t):
    own = t.incl_ms("encode_batch") - sum(
        t.incl_ms(s[2]) for s in STAGES[1:])
    return own / t.stage("encode_batch")["calls"]
