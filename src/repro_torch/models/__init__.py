"""Model assembly for the port (dense family; see ``repro/models``)."""
