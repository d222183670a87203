"""Serving stack for the port: engine, continuous scheduler, paged-KV
bookkeeping and scheduling policy (see ``repro/serving``)."""
