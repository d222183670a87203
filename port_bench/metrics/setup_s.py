"""Process start to the window's start: weights, the server's build, the
kernels' load (their first build in a checkout), the warm-up sweep and
the ramp."""


def read(ctx):
    return ctx.setup_s
