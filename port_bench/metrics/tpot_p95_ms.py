"""95th percentile, over every request completed in the window, of
(completion - first token) / (output tokens - 1)."""
import numpy as np


def read(ctx):
    v = [1e3 * (r.t_done - r.t_first) / (len(r.tokens) - 1)
         for r in ctx.records
         if r.t_done is not None and ctx.t0 <= r.t_done <= ctx.t_end
         and r.tokens is not None and len(r.tokens) > 1]
    return float(np.percentile(v, 95)) if v else None
