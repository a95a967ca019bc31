"""Host-side pair datasets (synthetic LiDAR pairs, numpy only) and the batching loader."""
