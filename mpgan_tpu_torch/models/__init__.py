"""Model definitions (MPGAN generator)."""
