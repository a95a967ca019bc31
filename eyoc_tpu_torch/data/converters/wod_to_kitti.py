"""Waymo Open Dataset v2 -> KITTI-format converter (offline, host-only; a copy
of eyoc_tpu/data/converters/wod_to_kitti.py: numpy only, the same bits).

Re-derivation of the reference converter (reference
assets/convert_wod_to_kitti.py:20-129): per-log `sequences/<log>/velodyne/
%06d.bin` with xyz-only float32 points (the reference drops reflectance,
lib/data_loaders.py:1290-1293) plus `poses.npy` of frame poses; logs with an
existing poses.npy are skipped for resume. The waymo-open-dataset / dask
imports are gated — this is an offline tool that runs where the raw parquet
data lives.
"""

from __future__ import annotations

import os

import numpy as np


def convert(wod_dir: str, out_dir: str, split: str = "training",
            lidar_name: int = 1):
    try:
        import dask.dataframe as dd
        from waymo_open_dataset import v2
        from waymo_open_dataset.v2.perception.utils import lidar_utils
    except ImportError as e:  # pragma: no cover - offline-only dependency
        raise ImportError(
            "waymo-open-dataset (v2 API) + dask are required for conversion; "
            "run this offline tool where the raw parquet data lives") from e

    def read(tag, context):
        path = os.path.join(wod_dir, split, tag, f"{context}.parquet")
        return dd.read_parquet(path)

    lidar_dir = os.path.join(wod_dir, split, "lidar")
    contexts = sorted(
        f[: -len(".parquet")] for f in os.listdir(lidar_dir) if f.endswith(".parquet")
    )
    base = os.path.join(out_dir, split, "sequences")
    for ci, context in enumerate(contexts):
        seq_dir = os.path.join(base, context)
        pose_path = os.path.join(seq_dir, "poses.npy")
        if os.path.exists(pose_path):  # resume-by-skip (reference :47-50)
            continue
        os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)

        lidar_df = read("lidar", context)
        calib_df = read("lidar_calibration", context)
        pose_df = read("vehicle_pose", context)
        merged = v2.merge(lidar_df, pose_df)

        calib = None
        for _, row in calib_df.iterrows():
            c = v2.LiDARCalibrationComponent.from_dict(row)
            if c.key.laser_name == lidar_name:
                calib = c
                break

        poses = []
        idx = 0
        for _, row in merged.iterrows():
            lidar = v2.LiDARComponent.from_dict(row)
            if lidar.key.laser_name != lidar_name:
                continue
            pose = v2.VehiclePoseComponent.from_dict(row)
            pts = lidar_utils.convert_range_image_to_point_cloud(
                lidar.range_image_return1, calib)
            xyz = np.asarray(pts)[:, :3].astype(np.float32)
            xyz.tofile(os.path.join(seq_dir, "velodyne", "%06d.bin" % idx))
            poses.append(np.asarray(pose.world_from_vehicle.transform).reshape(4, 4))
            idx += 1
        np.save(pose_path, np.asarray(poses))
        print(f"[{ci + 1}/{len(contexts)}] {context}: {idx} frames")


if __name__ == "__main__":  # pragma: no cover
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--wod_dir", default="/data/waymo_v2")
    p.add_argument("--out_dir", default="/data/waymo_kitti_format")
    p.add_argument("--split", default="training",
                   choices=["training", "validation", "testing"])
    args = p.parse_args()
    convert(args.wod_dir, args.out_dir, args.split)
