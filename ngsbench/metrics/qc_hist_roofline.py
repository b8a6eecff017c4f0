"""qc_hist_roofline: the least time of the window's qc_hist launches over
their device time, in percent. The least time is the bytes counted here
from the inputs' shape (each read's quality bytes, plus 4 bytes of length
per read, for every mate file of every call in the window) over the card's
HBM bandwidth; the device time is that of every qc_hist_kernel in the
profiler's trace of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.hbm_bytes_per_s:
        return None
    kernel_s = ctx.trace.op_seconds("qc_hist_kernel")
    if kernel_s <= 0:
        return None
    nbytes = sum(f["bases"] + 4 * f["reads"]
                 for c in ctx.calls for f in c["files"])
    return 100.0 * nbytes / ctx.hbm_bytes_per_s / kernel_s
