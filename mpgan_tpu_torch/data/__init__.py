"""JetNet data layer (numpy)."""
