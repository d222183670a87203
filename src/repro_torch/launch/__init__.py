"""Command-line launchers for the port."""
