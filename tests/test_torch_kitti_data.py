"""The port's file readers (eyoc_tpu_torch.data.io and .datasets) against
eyoc_tpu's on synthetic trees, numpy seeds stated below:

- a KITTI odometry tree (tests/test_runbook.py:21-38's layout: drive 00,
  calib.txt with Tr = I, poses.txt 2 m a frame along x; here 30 frames of a
  3000-point world seen from each pose, float32 xyzr .bin): the calibration
  and pose parsers equal; KittiNFramePairDataset, KittiRandDistPairDataset
  and KittiContinuousFramePairDataset give the same file lists and, at a
  fixed RandomState, the same clouds and T_gt (train phase: the random
  rotation and scale, the zero-overlap check) bit for bit; KITTIPairDataset
  and KITTINMPairDataset the same file lists, and KITTINMPairDataset's ICP
  ground truth (the port's ICP on the CPU against the JAX ICP, each tree
  with its own icp/ cache) within 1e-5, and read back from the cache;
- converted nuScenes (xyzr) and Waymo (xyz) trees with poses.npy: the N-frame
  and metric-distance readers' file lists and first items equal;
- the registry holds the JAX registry's names, ThreeDMatchPairDataset
  among them; IndoorPairDataset, in neither, still raises.
"""

import numpy as np
import pytest
import torch

import eyoc_tpu.data.datasets as JD
import eyoc_tpu_torch.data.datasets as TD
from eyoc_tpu import config as jconfig
from eyoc_tpu.data import io as jio
from eyoc_tpu_torch import config as tconfig
from eyoc_tpu_torch.data import io as tio

N_FRAMES = 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def world(seed=0, n=3000):
    """Ground points and a few walls (numpy seed `seed`)."""
    rng = np.random.default_rng(seed)
    g = np.c_[rng.uniform(-20, 80, (n // 2, 2)), rng.normal(-1.7, 0.02,
                                                             n // 2)]
    w = np.c_[rng.uniform(-20, 80, n - n // 2),
              rng.choice([-8.0, 9.0], n - n // 2),
              rng.uniform(-1.7, 3.0, n - n // 2)]
    w[:, 1] += rng.normal(0, 0.02, len(w))
    return np.concatenate([g, w]).astype(np.float64)


def kitti_tree(root, seed=0, radius=40.0):
    """<root>/dataset/sequences/00: velodyne/%06d.bin, calib.txt, poses.txt
    (camera-frame poses 2 m a frame along x; Tr = I); each scan the world
    points within `radius` (xy) of its pose."""
    seq = root / "dataset" / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    with open(seq / "calib.txt", "w") as f:
        for k in ("P0", "P1", "P2", "P3", "Tr"):
            f.write(f"{k}: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    pts = world(seed)
    rng = np.random.default_rng(seed + 1)
    with open(seq / "poses.txt", "w") as f:
        for t in range(N_FRAMES):
            f.write(f"1 0 0 {2.0 * t} 0 1 0 0 0 0 1 0\n")
            local = pts - [2.0 * t, 0.0, 0.0]
            local = local[np.linalg.norm(local[:, :2], axis=1) < radius]
            xyzr = np.c_[local + rng.normal(0, 0.01, local.shape),
                         np.full(len(local), 0.5)].astype(np.float32)
            xyzr.tofile(seq / "velodyne" / ("%06d.bin" % t))
    return str(root)


def converted_tree(root, phase_dir, names, floats, seed=0):
    """<root>/<phase_dir>/sequences/<name>/{velodyne/*.bin, poses.npy}, the
    LiDAR-frame poses 1.5 m a frame along x."""
    pts = world(seed)
    rng = np.random.default_rng(seed + 2)
    for name in names:
        seq = root / phase_dir / "sequences" / name
        (seq / "velodyne").mkdir(parents=True)
        poses = np.tile(np.eye(4), (N_FRAMES, 1, 1))
        poses[:, 0, 3] = 1.5 * np.arange(N_FRAMES)
        np.save(seq / "poses.npy", poses)
        for t in range(N_FRAMES):
            local = pts - poses[t, :3, 3]
            cols = [local + rng.normal(0, 0.01, local.shape)]
            if floats == 4:
                cols.append(np.full((len(local), 1), 0.5))
            np.concatenate(cols, 1).astype(np.float32).tofile(
                seq / "velodyne" / ("%06d.bin" % t))
    return str(root)


def configs(root, **over):
    """(JAX Config, port Config) from each package's parser defaults."""
    argv = ["--kitti_root", root, "--pair_min_dist", "1",
            "--pair_max_dist", "4"]
    j = jconfig.Config(vars(jconfig.build_parser().parse_args(argv)))
    t = tconfig.Config(vars(tconfig.build_parser().parse_args(argv)))
    j.update(over)
    t.update(over)
    return j, t


@pytest.fixture
def one_drive_split(tmp_path, monkeypatch):
    """Both packages' KITTI split files list drive 00 only."""
    split = tmp_path / "split_00.txt"
    split.write_text("00\n")
    monkeypatch.setattr(JD, "_split_file", lambda name: str(split))
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))


def same_item(a, b):
    for k in ("xyz0", "xyz1", "T_gt"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for k in ("frame_distance", "search_radius", "meta"):
        assert a[k] == b[k], k


def test_parsers_match_jax(tmp_path):
    root = kitti_tree(tmp_path)
    seq = root + "/dataset/sequences/00"
    cj = jio.parse_calibration(seq + "/calib.txt")
    ct = tio.parse_calibration(seq + "/calib.txt")
    assert set(cj) == set(ct) and all(np.array_equal(cj[k], ct[k])
                                      for k in cj)
    sj = jio.KittiOdometryStore(root + "/dataset")
    st = tio.KittiOdometryStore(root + "/dataset")
    assert sj.scan_ids(0) == st.scan_ids(0) == list(range(N_FRAMES))
    assert np.array_equal(sj.poses(0), st.poses(0))
    assert np.array_equal(sj.raw_cam_poses(0), st.raw_cam_poses(0))
    assert np.array_equal(sj.xyz(0, 5), st.xyz(0, 5))


@pytest.mark.parametrize("name", ["KittiNFramePairDataset",
                                  "KittiRandDistPairDataset",
                                  "KittiContinuousFramePairDataset"])
def test_kitti_readers_match_jax(tmp_path, one_drive_split, name):
    root = kitti_tree(tmp_path)
    jc, tc = configs(root, use_random_scale=True, max_epoch=4)
    for phase, rot, scale in (("train", True, True), ("test", False, False)):
        dj = getattr(JD, name)(phase, jc, random_rotation=rot,
                               random_scale=scale)
        dt = TD.dataset_str_mapping[name](phase, tc, random_rotation=rot,
                                          random_scale=scale)
        assert dj.files == dt.files and len(dt.files) > 0
        assert dj.label_mode() == dt.label_mode()
        for i in range(min(3, len(dt.files))):
            same_item(dj[i], dt[i])
    if name == "KittiContinuousFramePairDataset":
        grown = dt.update_extension_distance(3)
        assert dj.update_extension_distance(3) == grown
        assert dj.files == dt.files


def test_legacy_readers_and_icp_gt_match_jax(tmp_path, one_drive_split):
    # a tree each: each reader caches its ICP result under <root>/icp
    rj = kitti_tree(tmp_path / "jax")
    rt = kitti_tree(tmp_path / "port")
    jc, _ = configs(rj, pair_min_dist=3)
    _, tc = configs(rt, pair_min_dist=3)
    for name in ("KITTIPairDataset", "KITTINMPairDataset"):
        dj = getattr(JD, name)("test", jc)
        dt = TD.dataset_str_mapping[name]("test", tc)
        assert dj.files == dt.files and len(dt.files) > 0
    dt.device = "cpu"
    a, b = dj[0], dt[0]
    assert np.array_equal(a["xyz0"], b["xyz0"])
    np.testing.assert_allclose(b["T_gt"], a["T_gt"], rtol=0, atol=1e-5)
    assert a["meta"] == b["meta"]
    # the pose is read back from the cache by a new reader
    again = TD.KITTINMPairDataset("test", tc)[0]
    assert np.array_equal(again["T_gt"], b["T_gt"])


@pytest.mark.parametrize("family,phase_dir,floats", [
    ("Nuscenes", "test", 4), ("Waymo", "testing", 3)])
def test_converted_readers_match_jax(tmp_path, family, phase_dir, floats):
    root = converted_tree(tmp_path, phase_dir, ["seq-a", "seq-b"], floats)
    jc, tc = configs(root)
    for kind in ("NFramePairDataset", "RandDistPairDataset"):
        name = family + kind
        dj = getattr(JD, name)("test", jc, random_rotation=False,
                               random_scale=False)
        dt = TD.dataset_str_mapping[name]("test", tc, random_rotation=False,
                                          random_scale=False)
        assert dj.files == dt.files and len(dt.files) > 0
        same_item(dj[0], dt[0])
        assert dt[0]["xyz0"].shape[1] == 3


def test_3dmatch_still_raises():
    """ThreeDMatchPairDataset resolves to the port's reader, as the JAX
    registry's name does to JAX's; IndoorPairDataset, its base class, is
    in neither registry and still raises."""
    assert TD.dataset_str_mapping["ThreeDMatchPairDataset"] is \
        TD.ThreeDMatchPairDataset
    assert list(TD.dataset_str_mapping) == list(JD.dataset_str_mapping)
    assert "IndoorPairDataset" not in JD.dataset_str_mapping
    with pytest.raises(NotImplementedError, match="neither"):
        TD.dataset_str_mapping["IndoorPairDataset"]
