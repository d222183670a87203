"""Output tokens the clients received in the window over its seconds."""


def read(ctx):
    return sum(r.tokens for r in ctx.rounds) / ctx.window_s
