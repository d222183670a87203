"""Kernels in the profiled slice over the decode steps in it."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = sum(r.decode_steps for r in ctx.sliced)
    return len(ctx.trace.kernels()) / steps if steps else None
