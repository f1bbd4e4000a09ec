"""Command-line entry points (gen)."""
