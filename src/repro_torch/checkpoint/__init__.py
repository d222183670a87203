"""Checkpointing for the port: atomic, versioned, crc32-manifested saves
in the reference's on-disk format (see ``repro/checkpoint``)."""
