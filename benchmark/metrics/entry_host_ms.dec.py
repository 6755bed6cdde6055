"""decode_batch's own host time a call, ms: its wall less the native
parse, the copies and the device program; what is left is the streams'
header parse (prepare_batch), the frames' split and the counters."""
STAGES = [("models.decoder", "decode_batch", "decode_batch"),
          ("models.decoder", "parse_chunk", "native parse"),
          ("models.decoder", "upload_parsed", "upload", True),
          ("ops.ht_dec", "fused_decode", "device program", True),
          ("models.decoder", "download", "download", True)]


def read(t):
    own = t.incl_ms("decode_batch") - sum(
        t.incl_ms(s[2]) for s in STAGES[1:])
    return own / t.stage("decode_batch")["calls"]
