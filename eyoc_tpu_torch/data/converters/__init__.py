"""Offline converters of nuScenes and Waymo Open Dataset v2 into the KITTI
layout (host only; their devkits are imported inside `convert`)."""
