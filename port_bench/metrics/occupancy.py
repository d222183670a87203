"""Share of the window's decode-step row slots that delivered a token:
tokens from decode segments (output tokens less first tokens) over the
scheduler's decode steps in the window times its rows."""


def read(ctx):
    steps = sum(r.decode_steps for r in ctx.rounds)
    if not steps:
        return None
    decoded = sum(r.tokens - r.firsts for r in ctx.rounds)
    return 100.0 * decoded / (steps * ctx.rows)
