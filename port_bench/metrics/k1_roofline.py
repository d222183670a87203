"""K1 (the paged-attention decode kernel): the least time for the bytes
the profiled slice's decode steps need, over K1's device time in the
slice. Each live row's step reads its context's K and V once and its
query and output once (pb_flops.k1_step_bytes); which rows were live at
which step, and their contexts, follow from the requests sent, the round
that admitted each, and the quantum: in its ``j``-th round a row runs
decode steps ``quantum·j ..`` of its ``max_new - 1``, step ``k`` at a
context of ``prompt + k + 1`` keys."""
from pb_flops import PEAK, k1_step_bytes

# the split and merge kernels of csrc/paged_attention_split.cuh
NAMES = ("repro_pa",)


def read(ctx):
    if ctx.trace is None or not ctx.sliced:
        return None
    t = ctx.trace.device_s(lambda n: any(k in n for k in NAMES))
    if t <= 0:
        return None
    q, m = ctx.quantum, ctx.model
    need = 0.0
    for r in ctx.sliced:
        if not r.decode_steps:
            continue
        for rec in ctx.records:
            if rec.round_first is None or rec.round_first > r.index:
                continue
            j = r.index - rec.round_first
            plen = len(rec.req.prompt)
            for k in range(q * j, min(q * j + q, rec.req.max_new - 1)):
                need += k1_step_bytes(m, ctx.kv_bits, plen + k + 1)
    return 100.0 * need / PEAK["hbm_bytes_s"] / t
