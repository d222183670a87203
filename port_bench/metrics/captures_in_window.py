"""Graphs (segment and wave) captured inside the window: 0 when the
warm-up reached every key the window used."""


def read(ctx):
    a, b = ctx.captures
    return None if a is None else b - a
