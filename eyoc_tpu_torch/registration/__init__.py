"""SC2-PCR, RANSAC and ICP registration."""
