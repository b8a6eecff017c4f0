"""peak_rss_gib: the peak of the run process's resident set (VmRSS in
/proc/self/status) during the window, sampled every 10 ms, in GiB. It
counts the program's anonymous memory and the mapped libraries and file
pages it touches; the harness holds only file names then."""


def read(ctx):
    return ctx.host_peak_bytes / 2 ** 30
