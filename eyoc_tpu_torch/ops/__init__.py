"""Feature matching and the row gather."""
