"""Seconds from the start of the run to the start of the window: the
table generated, the program's state built (a resident load or a file
written), the kernels built where they are not yet, and the warm-up."""


def read(ctx):
    return ctx.setup_s
