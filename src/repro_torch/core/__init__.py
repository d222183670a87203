"""Core of the port: quantizers, profiles, the merged engine, and the
energy-aware profile manager (see ``repro/core``)."""
