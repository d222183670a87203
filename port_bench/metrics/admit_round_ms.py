"""Median host wall of the window's rounds in which an admission wave
replayed."""
import statistics


def read(ctx):
    v = [1e3 * (r.t1 - r.t0) for r in ctx.rounds if r.wave]
    return statistics.median(v) if v else None
