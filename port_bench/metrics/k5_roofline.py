"""K5 (the fake-quant kernel) on the MoE's per-forward routed stacks and
dispatch buffers: the least time for the bytes its calls in the profiled
slice need (pb_flops.k5_forward_bytes per forward: each decode step over
the pool's rows, each admission wave over its rows times its prompt
bucket, both powers of two), over ``aquant_fused_kernel``'s device time
in the slice."""
from pb_flops import PEAK, k5_forward_bytes


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def read(ctx):
    m = ctx.model
    if ctx.trace is None or m.get("moe") is None or not ctx.sliced:
        return None
    t = ctx.trace.device_s(lambda n: "aquant_fused_kernel" in n)
    if t <= 0:
        return None
    need = 0.0
    for r in ctx.sliced:
        need += r.decode_steps * k5_forward_bytes(m, ctx.rows)
        if r.admitted:
            a = _pow2(len(r.admitted))
            b = _pow2(max(8, max(len(x.req.prompt) for x in r.admitted)))
            need += k5_forward_bytes(m, a * b)
    return 100.0 * need / PEAK["hbm_bytes_s"] / t
