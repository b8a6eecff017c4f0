"""setup_s: from the start of the run's process to the window's start:
the imports, the warm-up, the inputs made from the seed and one untimed
call per input shape, on the host's clock."""


def read(ctx):
    return ctx.setup_s
