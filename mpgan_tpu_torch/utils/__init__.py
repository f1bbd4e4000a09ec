"""Weight import and export."""
