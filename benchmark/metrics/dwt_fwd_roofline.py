"""The forward DWT level kernels' share of their roofline, %: the least
time, the bytes every level must read (its input once) and write (its
four bands once) at the cell's shapes over the card's 3.35 TB/s, over the
device time the profiler gives the kernels named here.  The bytes are
counted from the shapes (benchmark/roofline.py), whatever implements the
level."""
from benchmark.roofline import HBM_BYTES_PER_S, dwt_bytes

KERNELS = ("dwt53_fwd_kernel", "dwt97_fwd_kernel")


def read(t):
    seconds = t.kernel_s(KERNELS)
    if not seconds:
        return None
    s = t.shape()
    nbytes = t.calls * dwt_bytes(s["frames"] * s["components"], s["rows"],
                                 s["columns"], s["levels"])
    return 100 * nbytes / HBM_BYTES_PER_S / seconds
