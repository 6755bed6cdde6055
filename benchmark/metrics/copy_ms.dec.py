"""Host ms a call in the decode's host-device copies: upload_parsed (the
quad words and the MagSgn pool) and download (the pixels; it waits for
the device program)."""
STAGES = [("models.decoder", "upload_parsed", "upload", True),
          ("models.decoder", "download", "download", True)]


def read(t):
    return (t.incl_ms("upload") + t.incl_ms("download")) / t.calls
