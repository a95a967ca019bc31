"""Sequence stores: KITTI odometry + converted (nuScenes/WOD) KITTI-format
trees (a copy of eyoc_tpu/data/io.py, numpy only, so the port never
imports the JAX package).

Semantics from the reference readers (reference lib/data_loaders.py:624-713):
- KITTI poses are Tr-conjugated into the velodyne frame:
  pose_velo = Tr^-1 @ pose_cam @ Tr
- converted datasets carry per-sequence `poses.npy` already in LiDAR frame
- velodyne `.bin` files: 4 floats/point for KITTI & converted nuScenes,
  3 floats/point for converted WOD (lib/data_loaders.py:1290-1293)
"""

from __future__ import annotations

import glob
import os

import numpy as np


def parse_calibration(filename: str) -> dict:
    calib = {}
    with open(filename) as f:
        for line in f:
            key, content = line.strip().split(":")
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def parse_kitti_poses(pose_filename: str, Tr: np.ndarray) -> np.ndarray:
    Tr_inv = np.linalg.inv(Tr)
    poses = []
    with open(pose_filename) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            poses.append(Tr_inv @ pose @ Tr)
    return np.asarray(poses)


class KittiOdometryStore:
    """root = <kitti_root>/dataset with sequences/%02d/{velodyne,calib.txt,poses.txt}."""

    point_floats = 4

    def __init__(self, root: str):
        self.root = root
        self._pose_cache = {}

    def scan_ids(self, drive) -> list:
        fnames = glob.glob(self.root + "/sequences/%02d/velodyne/*.bin" % int(drive))
        assert len(fnames) > 0, f"no data for drive {drive} under {self.root}"
        return sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)

    def poses(self, drive) -> np.ndarray:
        drive = int(drive)
        if drive not in self._pose_cache:
            seq = self.root + "/sequences/%02d" % drive
            calib = parse_calibration(seq + "/calib.txt")
            self._pose_cache[drive] = parse_kitti_poses(seq + "/poses.txt", calib["Tr"])
        return self._pose_cache[drive]

    def xyz(self, drive, t) -> np.ndarray:
        fname = self.root + "/sequences/%02d/velodyne/%06d.bin" % (int(drive), int(t))
        pts = np.fromfile(fname, dtype=np.float32).reshape(-1, self.point_floats)
        return pts[:, :3]

    def raw_cam_poses(self, drive) -> np.ndarray:
        """Camera-frame poses WITHOUT Tr conjugation — the legacy
        KITTIPairDataset composes its own hardcoded velo2cam instead
        (reference lib/data_loaders.py:365-379, 494-496)."""
        key = ("raw", int(drive))
        if key not in self._pose_cache:
            seq = self.root + "/sequences/%02d" % int(drive)
            poses = []
            with open(seq + "/poses.txt") as f:
                for line in f:
                    v = [float(x) for x in line.strip().split()]
                    p = np.zeros((4, 4))
                    p[0, :4] = v[0:4]
                    p[1, :4] = v[4:8]
                    p[2, :4] = v[8:12]
                    p[3, 3] = 1.0
                    poses.append(p)
            self._pose_cache[key] = np.asarray(poses)
        return self._pose_cache[key]


class ConvertedStore:
    """Converted nuScenes/WOD KITTI-format tree: sequences/<name>/{velodyne, poses.npy}."""

    def __init__(self, root: str, point_floats: int = 4):
        self.root = root
        self.point_floats = point_floats
        self._pose_cache = {}

    def sequence_names(self) -> list:
        return sorted(os.listdir(os.path.join(self.root, "sequences")))

    def scan_ids(self, dirname) -> list:
        fnames = glob.glob(self.root + "/sequences/%s/velodyne/*.bin" % dirname)
        assert len(fnames) > 0, f"no data for {dirname} under {self.root}"
        return sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)

    def poses(self, dirname) -> np.ndarray:
        if dirname not in self._pose_cache:
            path = os.path.join(self.root, "sequences", dirname, "poses.npy")
            if not os.path.exists(path):  # compatibility fallback (reference :701-703)
                path = os.path.join(self.root, "sequences", dirname, "velodyne", "poses.npy")
            arr = np.load(path)
            self._pose_cache[dirname] = arr.reshape(-1, 4, 4)
        return self._pose_cache[dirname]

    def xyz(self, dirname, t) -> np.ndarray:
        fname = self.root + "/sequences/%s/velodyne/%06d.bin" % (dirname, int(t))
        pts = np.fromfile(fname, dtype=np.float32).reshape(-1, self.point_floats)
        return pts[:, :3]
