"""Weight import and export, training figures and logging setup."""
