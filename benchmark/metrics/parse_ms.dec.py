"""Host parse a call, ms: decoder.parse_chunk, the native
ht_t2_parse_frames (Tier-2 and the MEL/VLC control phase)."""
STAGES = [("models.decoder", "parse_chunk", "native parse")]


def read(t):
    return t.incl_ms("native parse") / t.calls
