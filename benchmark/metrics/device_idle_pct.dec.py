"""The card's idle share of the traced window, %: 1 - the CUDA-event
spans of the outermost device stages (upload_parsed, the device program,
download) over the window; a lower bound, as device_idle_pct.enc."""
STAGES = [("models.decoder", "upload_parsed", "upload", True),
          ("ops.ht_dec", "fused_decode", "device program", True),
          ("models.decoder", "download", "download", True)]


def read(t):
    if t.report["busy_ms"] is None:
        return None
    return 100 * (1 - t.report["busy_ms"] / t.report["wall_ms"])
