"""The inverse DWT level kernels' share of their roofline, %: the bytes
every level must read (its four bands once) and write (its output once)
at the cell's shapes over 3.35 TB/s, over the device time the profiler
gives the kernels named here."""
from benchmark.roofline import HBM_BYTES_PER_S, dwt_bytes

KERNELS = ("dwt53_inv_kernel", "dwt97_inv_kernel")


def read(t):
    seconds = t.kernel_s(KERNELS)
    if not seconds:
        return None
    s = t.shape()
    nbytes = t.calls * dwt_bytes(s["frames"] * s["components"], s["rows"],
                                 s["columns"], s["levels"])
    return 100 * nbytes / HBM_BYTES_PER_S / seconds
