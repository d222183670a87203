"""The training loop of the port (see ``repro/train``)."""
