"""Multi-device execution over a process group (see ``repro/distrib``)."""
