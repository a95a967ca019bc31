"""The port's offline converters (eyoc_tpu_torch.data.converters) against
eyoc_tpu's, both numpy: `quat_to_rot` / `transform_matrix` / the frame
constants bit-equal on numpy seed 0 quaternions, and `convert` of both
converters over synthetic frames (numpy seed 1 for nuScenes, 2 for Waymo)
served by small fake devkit modules put in sys.modules (nuscenes-devkit's
NuScenes / create_splits_logs; waymo_open_dataset.v2's components, merge
and lidar_utils, and dask.dataframe.read_parquet): every written file
(velodyne/%06d.bin and poses.npy) bit-equal to JAX's, and a log whose
poses.npy exists skipped by the Waymo converter (its resume).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from eyoc_tpu.data.converters import nuscenes_to_kitti as JN
from eyoc_tpu.data.converters import wod_to_kitti as JW
from eyoc_tpu_torch.data.converters import nuscenes_to_kitti as TN
from eyoc_tpu_torch.data.converters import wod_to_kitti as TW


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quaternion_helpers_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(100):
        q = rng.normal(size=4) * rng.uniform(0.1, 10)
        assert np.array_equal(JN.quat_to_rot(*q), TN.quat_to_rot(*q))
        t = rng.normal(size=3) * 50
        assert np.array_equal(JN.transform_matrix(t, q),
                              TN.transform_matrix(t, q))
    assert np.array_equal(JN.KITTI_TO_NU, TN.KITTI_TO_NU)
    assert np.array_equal(JN.NU_TO_KITTI_R, TN.NU_TO_KITTI_R)


def tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def fake_nuscenes(dataroot, rng):
    """nuscenes.nuscenes.NuScenes and nuscenes.utils.splits over 2 logs of
    3 and 2 samples, with a third log's sample interleaved."""
    tables = {k: {} for k in ("sample", "sample_data", "calibrated_sensor",
                              "ego_pose", "scene", "log")}
    samples = []
    logs = {"log-a": 3, "log-b": 2, "log-c": 1}
    order = [("log-a", 0), ("log-c", 0), ("log-b", 0), ("log-a", 1),
             ("log-b", 1), ("log-a", 2)]
    for name in logs:
        tables["log"][f"L{name}"] = {"logfile": name}
        tables["scene"][f"S{name}"] = {"log_token": f"L{name}"}
    for k, (name, i) in enumerate(order):
        tok = f"s{k}"
        fn = f"sweeps/{tok}.bin"
        n = int(rng.integers(50, 120))
        rng.normal(0, 20, (n, 5)).astype(np.float32).tofile(
            os.path.join(dataroot, fn))
        for tab in ("calibrated_sensor", "ego_pose"):
            q = rng.normal(size=4)
            tables[tab][f"{tab}{k}"] = {
                "translation": list(rng.normal(size=3) * 10),
                "rotation": list(q / np.linalg.norm(q))}
        tables["sample_data"][f"d{k}"] = {
            "calibrated_sensor_token": f"calibrated_sensor{k}",
            "ego_pose_token": f"ego_pose{k}", "filename": fn}
        rec = {"token": tok, "scene_token": f"S{name}",
               "data": {"LIDAR_TOP": f"d{k}"}}
        tables["sample"][tok] = rec
        samples.append(rec)

    class NuScenes:
        def __init__(self, version, dataroot, verbose):
            self.dataroot = dataroot
            self.sample = samples

        def get(self, table, token):
            return tables[table][token]

    mods = {"nuscenes": types.ModuleType("nuscenes"),
            "nuscenes.nuscenes": types.ModuleType("nuscenes.nuscenes"),
            "nuscenes.utils": types.ModuleType("nuscenes.utils"),
            "nuscenes.utils.splits": types.ModuleType("nuscenes.utils.splits")}
    mods["nuscenes.nuscenes"].NuScenes = NuScenes
    mods["nuscenes.utils.splits"].create_splits_logs = \
        lambda split, nusc: ["log-a", "log-b"]
    return mods


def test_nuscenes_convert_bit_equal(tmp_path, monkeypatch):
    data = tmp_path / "nusc"
    (data / "sweeps").mkdir(parents=True)
    for name, mod in fake_nuscenes(str(data),
                                   np.random.default_rng(1)).items():
        monkeypatch.setitem(sys.modules, name, mod)
    JN.convert(str(data), str(tmp_path / "j"), "val")
    TN.convert(str(data), str(tmp_path / "t"), "val")
    j, t = tree_files(tmp_path / "j"), tree_files(tmp_path / "t")
    assert sorted(j) == sorted(t) and len(t) == 7    # 5 scans, 2 poses.npy
    assert all(j[k] == t[k] for k in t)
    poses = np.load(tmp_path / "t" / "val" / "sequences" / "log-a" /
                    "poses.npy")
    assert poses.shape == (3, 4, 4)


class _Frame:
    def __init__(self, rows):
        self.rows = rows

    def iterrows(self):
        return enumerate(self.rows)


def fake_waymo(wod_dir, rng, split="training"):
    """waymo_open_dataset.v2 and dask.dataframe over 2 contexts of 3 frames
    (two lasers a frame; laser 1 is converted)."""
    frames = {}
    lidar_dir = os.path.join(wod_dir, split, "lidar")
    os.makedirs(lidar_dir)
    for ctx in ("ctx-b", "ctx-a"):
        open(os.path.join(lidar_dir, f"{ctx}.parquet"), "w").close()
        lidar, calib, pose = [], [], []
        for laser in (2, 1):
            calib.append({"laser": laser,
                          "extrinsic": rng.normal(size=(4, 4))})
        for f in range(3):
            for laser in (1, 2):
                lidar.append({"laser": laser, "frame": f,
                              "ri": rng.normal(0, 30, (int(rng.integers(
                                  40, 90)), 4)).astype(np.float64)})
            pose.append({"frame": f, "T": list(rng.normal(size=16))})
        for tag, rows in (("lidar", lidar), ("lidar_calibration", calib),
                          ("vehicle_pose", pose)):
            frames[os.path.join(wod_dir, split, tag, f"{ctx}.parquet")] = \
                _Frame(rows)

    def ns(**kw):
        return types.SimpleNamespace(**kw)

    v2 = types.ModuleType("waymo_open_dataset.v2")
    v2.merge = lambda a, b: _Frame([dict(r, **{"T": next(
        p["T"] for p in b.rows if p["frame"] == r["frame"])}) for r in a.rows])
    v2.LiDARCalibrationComponent = ns(from_dict=lambda r: ns(
        key=ns(laser_name=r["laser"]), extrinsic=r["extrinsic"]))
    v2.LiDARComponent = ns(from_dict=lambda r: ns(
        key=ns(laser_name=r["laser"]), range_image_return1=r["ri"]))
    v2.VehiclePoseComponent = ns(from_dict=lambda r: ns(
        world_from_vehicle=ns(transform=r["T"])))
    lidar_utils = types.ModuleType("lidar_utils")
    lidar_utils.convert_range_image_to_point_cloud = \
        lambda ri, calib: ri @ calib.extrinsic
    top = types.ModuleType("waymo_open_dataset")
    top.v2 = v2
    perception = types.ModuleType("waymo_open_dataset.v2.perception")
    utils = types.ModuleType("waymo_open_dataset.v2.perception.utils")
    utils.lidar_utils = lidar_utils
    dask = types.ModuleType("dask")
    ddf = types.ModuleType("dask.dataframe")
    ddf.read_parquet = lambda path: frames[path]
    dask.dataframe = ddf
    return {"waymo_open_dataset": top, "waymo_open_dataset.v2": v2,
            "waymo_open_dataset.v2.perception": perception,
            "waymo_open_dataset.v2.perception.utils": utils,
            "dask": dask, "dask.dataframe": ddf}


def test_waymo_convert_bit_equal(tmp_path, monkeypatch, capsys):
    wod = tmp_path / "wod"
    for name, mod in fake_waymo(str(wod), np.random.default_rng(2)).items():
        monkeypatch.setitem(sys.modules, name, mod)
    JW.convert(str(wod), str(tmp_path / "j"))
    TW.convert(str(wod), str(tmp_path / "t"))
    j, t = tree_files(tmp_path / "j"), tree_files(tmp_path / "t")
    assert sorted(j) == sorted(t) and len(t) == 8    # 6 scans, 2 poses.npy
    assert all(j[k] == t[k] for k in t)
    out = capsys.readouterr().out
    assert "[1/2] ctx-a: 3 frames" in out
    # resume: a context whose poses.npy exists is skipped
    os.remove(tmp_path / "t" / "training" / "sequences" / "ctx-b" /
              "velodyne" / "000000.bin")
    TW.convert(str(wod), str(tmp_path / "t"))
    assert len(tree_files(tmp_path / "t")) == 7
