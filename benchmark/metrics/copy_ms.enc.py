"""Host ms a call in the encode's host-device copies: transforms.upload
of the frames and fused_encode.fetch_pool (the totals, then the used
pool into pinned memory; each waits for the device before it copies)."""
STAGES = [("models.transforms", "upload", "upload", True),
          ("models.fused_encode", "fetch_pool", "fetch", True)]


def read(t):
    return (t.incl_ms("upload") + t.incl_ms("fetch")) / t.calls
