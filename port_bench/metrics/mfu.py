"""Model FLOPs of the prompt and output tokens the window processed, over
the window's seconds times the card's bf16 peak: each prompt prefilled
in the window at its causal contexts, and each decoded token at its
context (pb_flops, from the configuration's shapes). A traced window's
seconds leave out the profiler's own start and stop."""
from pb_flops import PEAK, prefill_flops, token_flops


def read(ctx):
    m, flops = ctx.model, 0.0
    for r in ctx.rounds:
        for rec, n0, n1 in r.deltas:
            plen = len(rec.req.prompt)
            if n0 == 0 and n1 > 0:
                flops += prefill_flops(m, plen)
            for i in range(max(1, n0), n1):
                flops += token_flops(m, plen + i)
    return 100.0 * flops / ((ctx.window_s - ctx.profiler_s)
                           * PEAK["bf16_flops"])
