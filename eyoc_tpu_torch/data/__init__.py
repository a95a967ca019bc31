"""Host-side synthetic LiDAR pairs (numpy only)."""
