"""nuScenes -> KITTI-format converter (offline, host-only; a copy
of eyoc_tpu/data/converters/nuscenes_to_kitti.py: numpy only, the same bits).

Re-derivation of the reference's export_kitti_minimal.py
(reference assets/export_kitti_minimal.py:49-151): one LiDAR sweep per
sample, points rotated into the KITTI lidar frame, per-log
`sequences/<log>/velodyne/%06d.bin` (float32 x,y,z,intensity) plus
`poses.npy` holding lidar-to-world in the KITTI frame:
    lid_to_world_kitti = ego_to_world @ lid_to_ego @ R(kitti->nu)
Quaternion math is implemented here directly (no pyquaternion dependency);
the nuscenes-devkit import is gated since it is an offline-only extra.
"""

from __future__ import annotations

import os

import numpy as np


def quat_to_rot(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def transform_matrix(translation, rotation_wxyz) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_rot(*rotation_wxyz)
    T[:3, 3] = translation
    return T


# rotation about +z by pi/2 (kitti lidar frame -> nuScenes lidar frame)
KITTI_TO_NU = transform_matrix([0, 0, 0], (np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)))
NU_TO_KITTI_R = KITTI_TO_NU[:3, :3].T


def convert(nusc_dir: str, out_dir: str, split: str = "val",
            version: str = "v1.0-trainval", lidar_name: str = "LIDAR_TOP"):
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils.splits import create_splits_logs
    except ImportError as e:  # pragma: no cover - offline-only dependency
        raise ImportError(
            "nuscenes-devkit is required for conversion (offline tool); "
            "install it on a machine with the raw dataset") from e

    nusc = NuScenes(version=version, dataroot=nusc_dir, verbose=True)
    split_logs = create_splits_logs(split, nusc)
    base = os.path.join(out_dir, split, "sequences")
    os.makedirs(base, exist_ok=True)

    for log in split_logs:
        tokens = _split_to_samples(nusc, log)
        log_dir = os.path.join(base, log, "velodyne")
        os.makedirs(log_dir, exist_ok=True)
        poses = []
        for idx, sample_token in enumerate(tokens):
            sample = nusc.get("sample", sample_token)
            lidar_token = sample["data"][lidar_name]
            sd = nusc.get("sample_data", lidar_token)
            cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            pos = nusc.get("ego_pose", sd["ego_pose_token"])
            ego_to_world = transform_matrix(pos["translation"], pos["rotation"])
            lid_to_ego = transform_matrix(cs["translation"], cs["rotation"])
            lid_to_world_kitti = ego_to_world @ lid_to_ego @ KITTI_TO_NU
            poses.append(lid_to_world_kitti)

            pts = np.fromfile(
                os.path.join(nusc.dataroot, sd["filename"]), np.float32
            ).reshape(-1, 5)[:, :4]  # x, y, z, intensity
            pts[:, :3] = pts[:, :3] @ NU_TO_KITTI_R.T
            pts.astype(np.float32).tofile(os.path.join(log_dir, "%06d.bin" % idx))
        np.save(os.path.join(base, log, "poses.npy"), np.asarray(poses))


def _split_to_samples(nusc, log_name):
    out = []
    for sample in nusc.sample:
        scene = nusc.get("scene", sample["scene_token"])
        log = nusc.get("log", scene["log_token"])
        if log["logfile"] == log_name:
            out.append(sample["token"])
    return out


if __name__ == "__main__":  # pragma: no cover
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--nusc_dir", default="/data/NUSCENES")
    p.add_argument("--out_dir", default="/data/nuscenes_kitti_format")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args()
    for split in ("train", "val", "test"):
        convert(args.nusc_dir, args.out_dir, split, args.version)
