"""Feature matching."""
