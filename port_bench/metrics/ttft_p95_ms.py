"""95th percentile, over every request whose first token came in the
window, of submission to first token."""
import numpy as np


def read(ctx):
    v = [1e3 * (r.t_first - r.t_sub) for r in ctx.records
         if r.t_first is not None and ctx.t0 <= r.t_first <= ctx.t_end]
    return float(np.percentile(v, 95)) if v else None
