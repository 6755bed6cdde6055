"""The card's idle share of the traced window, %: 1 - the CUDA-event
spans of the outermost device stages (the device program with its upload,
the fetch) over the window.  The spans hold the program's own waits for
the host, so the share is a lower bound (the frozen StageClock's
idle_lower)."""
STAGES = [("models.fused_encode", "fused_encode_chunk", "device program",
           True),
          ("models.fused_encode", "fetch_pool", "fetch", True)]


def read(t):
    if t.report["busy_ms"] is None:
        return None
    return 100 * (1 - t.report["busy_ms"] / t.report["wall_ms"])
