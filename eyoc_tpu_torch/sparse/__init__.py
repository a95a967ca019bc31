"""Sparse voxel engine: Morton keys, voxelization, brick pyramid, sparse convs."""
