"""Optimizers for the port (see ``repro/optim``)."""
