"""Pair datasets (counterpart of eyoc_tpu/data/datasets.py): the
reference's file readers, KITTI (`KittiNFramePairDataset`,
`KittiRandDistPairDataset`, `KittiContinuousFramePairDataset`, :130-248,
and the legacy `KITTIPairDataset` / `KITTINMPairDataset` with their ICP
ground truth, :939-1073), nuScenes and Waymo over converted KITTI-format
trees (:250-410), and the two synthetic datasets, `SyntheticPairDataset`
(:412) and `SyntheticContinuousPairDataset` (:859-936), over the port's
scene builder (`data/synthetic.py`, whose clouds are bit-identical to the
JAX package's for the same seed).

Each file reader builds the reference's pair list exactly (the same
`np.random.seed(0)` draws, strides and pruning, from the split files in
`eyoc_tpu_torch/assets/`). `__getitem__` returns raw augmented clouds and
the ground-truth pose; voxelization and the GT correspondences run on the
device. The legacy readers' ICP runs through the port's ICP on
`self.device` (None: the card), cached as .npy under <kitti_root>/icp as
the JAX package caches it. The indoor readers, `IndoorPairDataset` and
`ThreeDMatchPairDataset` (:1076-1140), read 3DMatch's npz fragments
through its `<scene>*0.30.txt` overlap lists. `dataset_str_mapping` holds
the JAX registry's names and raises NotImplementedError for any other.
"""

from __future__ import annotations

import os

import numpy as np

from eyoc_tpu_torch.data.io import ConvertedStore, KittiOdometryStore
from eyoc_tpu_torch.data.synthetic import (SyntheticPairs, apply_transform,
                                           augment_pair, sample_random_trans)

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")


class PairDatasetBase:
    """Common state (reference PairDataset, lib/data_loaders.py:103-141).
    `device` is where a reader's ICP ground truth runs (None: the card)."""

    device = None

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        self.phase = phase
        self.config = config
        self.files: list = []
        self.voxel_size = config.voxel_size
        self.matching_search_voxel_size = (
            config.voxel_size * config.positive_pair_search_voxel_size_multiplier
        )
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.rotation_range = config.rotation_range
        self.randg = np.random.RandomState()
        self.reset_seed()
        self.MIN_DIST = config.pair_min_dist
        self.MAX_DIST = config.pair_max_dist
        self.supervised = config.supervised
        self.skip_initialization = bool(config.get("skip_initialization", False))

    def reset_seed(self, seed=0):
        self.randg.seed(seed)

    def __len__(self):
        return len(self.files)

    def is_base_dataset(self) -> bool:
        return self.MAX_DIST <= 1

    def label_mode(self) -> str:
        """Which correspondence labels the trainer computes on the device
        (reference lib/data_loaders.py:948-957)."""
        if (self.MAX_DIST <= 1 and self.phase == "train"
                and not self.skip_initialization):
            return "identity"
        if self.phase != "train" or self.supervised:
            return "gt"
        return "none"


    # -- to be provided by subclasses
    def _store(self):
        raise NotImplementedError

    def _has_overlap(self, xyz0, xyz1, trans, radius, cap=8192):
        """Cheap host-side zero-overlap check: any warped cloud0 point
        within `radius` of cloud1 (subsampled cKDTree). Proxy for the
        reference's 'len(matches) == 0' test after full GT matching
        (lib/data_loaders.py:958-961)."""
        from scipy.spatial import cKDTree

        a = xyz0 if len(xyz0) <= cap else xyz0[
            self.randg.choice(len(xyz0), cap, replace=False)]
        b = xyz1 if len(xyz1) <= cap else xyz1[
            self.randg.choice(len(xyz1), cap, replace=False)]
        w = a @ trans[:3, :3].T + trans[:3, 3]
        d, _ = cKDTree(b).query(w, k=1, distance_upper_bound=radius * 1.001)
        return bool(np.isfinite(d).any())

    def __getitem__(self, idx, _depth=0):
        """The file readers' item (eyoc_tpu/data/datasets.py:85-121)."""
        drive, t0, t1 = self.files[idx]
        store = self._store()
        poses = store.poses(drive)
        pos0, pos1 = poses[int(t0)], poses[int(t1)]
        xyz0 = store.xyz(drive, t0)
        xyz1 = store.xyz(drive, t1)
        M2 = np.linalg.inv(pos1) @ pos0
        xyz0, xyz1, trans, search = augment_pair(
            xyz0, xyz1, M2, self.randg,
            random_rotation=self.random_rotation,
            rotation_range=np.pi / 4,
            random_scale=self.random_scale,
            min_scale=self.min_scale,
            max_scale=self.max_scale,
            search_voxel_size=self.matching_search_voxel_size,
        )
        # zero-overlap resample (reference lib/data_loaders.py:958-961),
        # only where labels are computed, at most 3 deep
        if (self.label_mode() != "none" and _depth < 3
                and not self._has_overlap(xyz0, xyz1, trans, search)):
            self.resample_count = getattr(self, "resample_count", 0) + 1
            return self.__getitem__(
                int(self.randg.randint(len(self.files))), _depth + 1)
        return {
            "xyz0": xyz0,
            "xyz1": xyz1,
            "T_gt": trans,
            "frame_distance": int(t1) - int(t0),
            "search_radius": search,
            "meta": (drive, int(t0), int(t1)),
        }


# --------------------------------------------------------------------- KITTI


def _split_file(name: str) -> str:
    return os.path.join(_ASSET_DIR, name)


class KittiNFramePairDataset(PairDatasetBase):
    """Frame-interval pairs (reference lib/data_loaders.py:716-979)."""

    DATA_FILES = {
        "train": "train_kitti.txt",
        "val": "val_kitti.txt",
        "test": "test_kitti.txt",
    }

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        super().__init__(phase, config, random_rotation, random_scale)
        self.root = config.kitti_root + "/dataset"
        self.store = KittiOdometryStore(self.root)
        if phase == "test" and config.LoKITTI:
            self.files = [tuple(r) for r in np.load(
                os.path.join(_ASSET_DIR, "file_LoKITTI_50.npy"))]
        else:
            self.prepare_files(phase)
        if config.percentage != 1.0:
            self.files = self.files[: int(len(self.files) * config.percentage)]

    def _store(self):
        return self.store

    def _drives(self, phase):
        with open(_split_file(self.DATA_FILES[phase])) as f:
            return [int(x) for x in f.read().split()]

    def prepare_files(self, phase):
        """Exact reference sampling loop (lib/data_loaders.py:757-791)."""
        for drive_id in self._drives(phase):
            inames = self.store.scan_ids(drive_id)
            iname_set = set(inames)
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = max(
                    1,
                    int(self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)),
                )
                if (curr_time + dist_tmp) in iname_set:
                    self.files.append((drive_id, curr_time, curr_time + dist_tmp))
                    curr_time += 11
                else:
                    curr_time += 1


class KittiRandDistPairDataset(KittiNFramePairDataset):
    """Metric-distance pairs (reference lib/data_loaders.py:1393-1475)."""

    def prepare_files(self, phase):
        for drive_id in self._drives(phase):
            inames = self.store.scan_ids(drive_id)
            iname_set = set(inames)
            Ts = self.store.poses(drive_id)[:, :3, 3]
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)
                right = np.sqrt(
                    ((Ts[curr_time: curr_time + int(10 * self.MAX_DIST)]
                      - Ts[curr_time].reshape(1, 3)) ** 2).sum(-1)
                )
                beyond = np.where(right > dist_tmp)[0]
                if len(beyond) == 0:
                    curr_time += 1
                else:
                    next_time = beyond[0] + curr_time - 1
                    if next_time in iname_set:
                        self.files.append((drive_id, curr_time, next_time))
                        curr_time += 11
                    else:
                        curr_time += 1
        if phase == "test":
            self.files = self.files[::3]


class _ContinuousMixin:
    """Progressive distance extension (reference lib/data_loaders.py:1583-1650)."""

    def _init_continuous(self, config, phase):
        self.FIRST_DIST = config.pair_min_dist
        self.LAST_DIST = config.pair_max_dist
        if phase == "train":
            self.MIN_DIST = self.FIRST_DIST
            self.MAX_DIST = self.FIRST_DIST
            self.files = []
            self.prepare_files(phase)
        self.max_epoch = config.max_epoch - 1
        self.last_altered_epoch = 0
        if config.extension_steps > 0:
            self.extension_epoch_interval = int(config.max_epoch / config.extension_steps)
        else:
            self.extension_epoch_interval = 1

    def update_extension_distance(self, epoch):
        if not (epoch - self.last_altered_epoch >= self.extension_epoch_interval):
            return False
        expected = int((self.LAST_DIST - self.FIRST_DIST) * (epoch / self.max_epoch)) + self.FIRST_DIST
        if expected == self.MAX_DIST:
            return False
        self.MAX_DIST = expected
        self.last_altered_epoch = epoch
        self.files = []
        self.prepare_files(self.phase)
        return self.MAX_DIST

    def is_base_dataset(self):
        return self.MAX_DIST == 1


class KittiContinuousFramePairDataset(_ContinuousMixin, KittiNFramePairDataset):
    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        KittiNFramePairDataset.__init__(self, phase, config, random_rotation, random_scale)
        self._init_continuous(config, phase)


# --------------------------------------------------------- nuScenes (converted)


class NuscenesNFramePairDataset(PairDatasetBase):
    """reference lib/data_loaders.py:982-1183; root = kitti_root/<phase>."""

    stride_after_accept = 8
    point_floats = 4

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        super().__init__(phase, config, random_rotation, random_scale)
        self.root = os.path.join(config.kitti_root, phase)
        self.store = ConvertedStore(self.root, point_floats=self.point_floats)
        if phase == "test" and config.get("LoNUSCENES", False):
            self.files = [tuple(r) for r in np.load(
                os.path.join(_ASSET_DIR, "file_LoNUSCENES_50.npy"), allow_pickle=True)]
        else:
            self.prepare_files(phase)
        if config.percentage != 1.0:
            self.files = self.files[: int(len(self.files) * config.percentage)]

    def _store(self):
        return self.store

    def prepare_files(self, phase):
        """Frame-interval sampling with the 100 m discontinuity guard
        (reference lib/data_loaders.py:1019-1057)."""
        for dirname in self.store.sequence_names():
            inames = self.store.scan_ids(dirname)
            iname_set = set(inames)
            Ts = self.store.poses(dirname)[:, :3, 3]
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = max(
                    1,
                    int(self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)),
                )
                if (curr_time + dist_tmp) in iname_set:
                    next_time = curr_time + dist_tmp
                    if np.linalg.norm(Ts[curr_time] - Ts[next_time]) > 100:
                        curr_time += 1
                    else:
                        self.files.append((dirname, curr_time, next_time))
                        curr_time += self.stride_after_accept
                else:
                    curr_time += 1


class NuscenesRandDistPairDataset(NuscenesNFramePairDataset):
    def prepare_files(self, phase):
        for dirname in self.store.sequence_names():
            inames = self.store.scan_ids(dirname)
            iname_set = set(inames)
            Ts = self.store.poses(dirname)[:, :3, 3]
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)
                right = np.sqrt(
                    ((Ts[curr_time: curr_time + int(10 * self.MAX_DIST)]
                      - Ts[curr_time].reshape(1, 3)) ** 2).sum(-1)
                )
                beyond = np.where(right > dist_tmp)[0]
                if len(beyond) == 0:
                    curr_time += 1
                else:
                    next_time = beyond[0] + curr_time - 1
                    if next_time in iname_set and np.linalg.norm(
                        Ts[curr_time] - Ts[next_time]
                    ) <= 100:
                        self.files.append((dirname, curr_time, next_time))
                        curr_time += 11
                    else:
                        curr_time += 1
        if phase == "test":
            self.files = self.files[::3]


class NuscenesContinuousFramePairDataset(_ContinuousMixin, NuscenesNFramePairDataset):
    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        NuscenesNFramePairDataset.__init__(self, phase, config, random_rotation, random_scale)
        self._init_continuous(config, phase)


# ------------------------------------------------------------ WOD (converted)


class WaymoNFramePairDataset(PairDatasetBase):
    """reference lib/data_loaders.py:1187-1390; xyz-only bins, [::4] pruning."""

    phase_dir_mapping = {"train": "training", "val": "validation", "test": "testing"}
    stride_after_accept = 8
    point_floats = 3

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        super().__init__(phase, config, random_rotation, random_scale)
        self.root = os.path.join(config.kitti_root, self.phase_dir_mapping[phase])
        self.store = ConvertedStore(self.root, point_floats=self.point_floats)
        if phase == "test" and config.get("LoWAYMO", False):
            raise NotImplementedError("LoWAYMO has yet to be built (reference parity)")
        self.prepare_files(phase)
        if config.percentage != 1.0:
            self.files = self.files[: int(len(self.files) * config.percentage)]

    def _store(self):
        return self.store

    def prepare_files(self, phase):
        for dirname in self.store.sequence_names():
            inames = self.store.scan_ids(dirname)
            iname_set = set(inames)
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = max(
                    1,
                    int(self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)),
                )
                if (curr_time + dist_tmp) in iname_set:
                    self.files.append((dirname, curr_time, curr_time + dist_tmp))
                    curr_time += self.stride_after_accept
                else:
                    curr_time += 1
        if phase in ("train", "val"):
            self.files = self.files[::4]


class WaymoRandDistPairDataset(WaymoNFramePairDataset):
    def prepare_files(self, phase):
        for dirname in self.store.sequence_names():
            inames = self.store.scan_ids(dirname)
            iname_set = set(inames)
            Ts = self.store.poses(dirname)[:, :3, 3]
            curr_time = inames[0]
            np.random.seed(0)
            while curr_time in iname_set:
                dist_tmp = self.MIN_DIST + np.random.rand() * (self.MAX_DIST - self.MIN_DIST)
                right = np.sqrt(
                    ((Ts[curr_time: curr_time + int(10 * self.MAX_DIST)]
                      - Ts[curr_time].reshape(1, 3)) ** 2).sum(-1)
                )
                beyond = np.where(right > dist_tmp)[0]
                if len(beyond) == 0:
                    curr_time += 1
                else:
                    next_time = beyond[0] + curr_time - 1
                    if next_time in iname_set:
                        self.files.append((dirname, curr_time, next_time))
                        curr_time += 11
                    else:
                        curr_time += 1
        if phase == "test":
            self.files = self.files[::3]


class WaymoContinuousFramePairDataset(_ContinuousMixin, WaymoNFramePairDataset):
    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        WaymoNFramePairDataset.__init__(self, phase, config, random_rotation, random_scale)
        self._init_continuous(config, phase)


# ------------------------------------------------------------------ synthetic


class SyntheticPairDataset(PairDatasetBase, SyntheticPairs):
    """KITTI-like synthetic LiDAR pairs: item `idx` raycasts scene
    `seed0 + idx` from two sensor poses `dist` apart, then augments it with
    the dataset's own RandomState (the JAX dataset's draws, in order)."""

    def __init__(self, phase, config, random_rotation=True, random_scale=False,
                 n_pairs=64, n_points=65536, dist=None):
        super().__init__(phase, config, random_rotation, random_scale)
        self.n_points = n_points
        self.dist = dist if dist is not None else max(
            5.0, float(config.pair_max_dist))
        self.files = [(0, i, i + 1) for i in range(n_pairs)]
        self.facade_len_scale = float(config.get("facade_len_scale", 1.0))
        self.facade_gap_scale = float(config.get("facade_gap_scale", 1.0))

    # raw scenes are cached: within an extension stage the same (seed0,
    # idx, schedule) rebuilds the same scene, and the raycast takes seconds
    # a pair on the host; the augmentation stays fresh (datasets.py:783-790)
    _SCENE_CACHE_MAX = 96

    def _scene_key(self, idx):
        return (self.seed0, idx, float(getattr(self, "MAX_DIST", self.dist)),
                self.phase)

    def __getitem__(self, idx):
        key = self._scene_key(idx)
        cache = getattr(self, "_scene_cache", None)
        if cache is None:
            cache = self._scene_cache = {}
        if key not in cache:
            if len(cache) >= self._SCENE_CACHE_MAX:
                cache.clear()
            cache[key] = self._build_scene(idx)
        xyz0, xyz1, M2, d = cache[key]
        xyz0, xyz1, trans, search = augment_pair(
            xyz0, xyz1, M2, self.randg,
            random_rotation=self.random_rotation,
            random_scale=self.random_scale,
            min_scale=self.min_scale, max_scale=self.max_scale,
            search_voxel_size=self.matching_search_voxel_size,
        )
        return {
            "xyz0": xyz0, "xyz1": xyz1, "T_gt": trans,
            "frame_distance": max(1, int(round(d))),
            "search_radius": search, "meta": (0, idx, idx + 1),
        }


class SyntheticContinuousPairDataset(SyntheticPairDataset):
    """EYOC's progressive extension over synthetic scenes: `pair_min_dist`
    and `pair_max_dist` are the first and last maximum sensor separation
    (m); `update_extension_distance(epoch)` grows MAX_DIST linearly over
    `max_epoch` (every `extension_steps`-th of the run, 0 = every epoch)
    and each train item draws d ~ U[1, MAX_DIST]. Base mode is MAX_DIST
    <= 1 (identity-pose labels). Scenes are reseeded once per extension
    interval. Pairs and points per epoch come from the config keys
    `synthetic_pairs_per_epoch` (32) and `synthetic_points` (65536)."""

    def __init__(self, phase, config, random_rotation=True,
                 random_scale=False, n_pairs=None, n_points=None):
        if n_pairs is None:
            n_pairs = int(config.get("synthetic_pairs_per_epoch", 32))
        if n_points is None:
            n_points = int(config.get("synthetic_points", 65536))
        super().__init__(phase, config, random_rotation, random_scale,
                         n_pairs=n_pairs, n_points=n_points,
                         dist=config.pair_min_dist)
        self.FIRST_DIST = config.pair_min_dist
        self.LAST_DIST = config.pair_max_dist
        # val and test evaluate at the final distance
        self.MAX_DIST = self.FIRST_DIST if phase == "train" else self.LAST_DIST
        self.dist = float(self.MAX_DIST)
        self.max_epoch = config.max_epoch - 1
        self.last_altered_epoch = 0
        self._last_reseed_epoch = 0
        if config.extension_steps > 0:
            self.extension_epoch_interval = int(
                config.max_epoch / config.extension_steps)
        else:
            self.extension_epoch_interval = 1

    def update_extension_distance(self, epoch):
        """Fresh scenes once per extension interval; the new MAX_DIST, or
        False when it did not change (datasets.py:904-922)."""
        if epoch - self._last_reseed_epoch >= self.extension_epoch_interval:
            self.seed0 = 1000 + 100003 * epoch
            self._last_reseed_epoch = epoch
        if not (epoch - self.last_altered_epoch
                >= self.extension_epoch_interval):
            return False
        expected = int((self.LAST_DIST - self.FIRST_DIST)
                       * (epoch / max(self.max_epoch, 1))) + self.FIRST_DIST
        if expected == self.MAX_DIST:
            return False
        self.MAX_DIST = expected
        self.last_altered_epoch = epoch
        return self.MAX_DIST

    def _item_dist(self, idx, rng):
        if self.MAX_DIST <= 1 or self.phase != "train":
            return float(self.MAX_DIST)
        return float(rng.uniform(1.0, float(self.MAX_DIST)))


# ------------------------------------------------- legacy KITTI (ICP GT)


# hardcoded velodyne->camera calibration of the legacy dataset (reference
# lib/data_loaders.py:365-379 — note it deliberately ignores calib.txt)
_VELO2CAM = None


def _velo2cam() -> np.ndarray:
    global _VELO2CAM
    if _VELO2CAM is None:
        R = np.array([
            7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02,
            7.280733e-04, -9.998902e-01, 9.998621e-01, 7.523790e-03,
            1.480755e-02]).reshape(3, 3)
        T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
        _VELO2CAM = np.vstack((np.hstack([R, T]), [0, 0, 0, 1])).T
    return _VELO2CAM


class KITTIPairDataset(PairDatasetBase):
    """Legacy FCGF KITTI pairs: every (t, t+dt) with dt in [2,
    kitti_max_time_diff), GT = velo2cam-conjugated odometry refined by ICP
    and cached as .npy under <kitti_root>/icp (reference
    lib/data_loaders.py:306-582). The Open3D ICP becomes the port's
    fixed-iteration point-to-point ICP (registration/icp.py: K2 and
    `icp_solve`), on the card unless the dataset's `device` says otherwise
    (make_data_loader sets it)."""

    DATA_FILES = {
        "train": "train_kitti.txt",
        "val": "val_kitti.txt",
        "test": "test_kitti.txt",
    }
    TEST_RANDOM_ROTATION = False

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        super().__init__(phase, config, random_rotation, random_scale)
        self.root = config.kitti_root + "/dataset"
        self.store = KittiOdometryStore(self.root)
        self.icp_path = os.path.join(config.kitti_root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        self._icp_cache: dict = {}
        if phase == "test":
            self.random_rotation = self.TEST_RANDOM_ROTATION
        max_time_diff = int(config.get("kitti_max_time_diff", 3))
        with open(_split_file(self.DATA_FILES[phase])) as f:
            subset_names = f.read().split()
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = set(self.store.scan_ids(drive_id))
            for start_time in sorted(inames):
                for time_diff in range(2, max_time_diff):
                    pair_time = time_diff + start_time
                    if pair_time in inames:
                        self.files.append((drive_id, start_time, pair_time))

    def _icp_gt(self, drive, t0, t1, xyz0, xyz1) -> np.ndarray:
        from eyoc_tpu_torch.registration.icp import icp_refine_numpy

        key = "%d_%d_%d" % (drive, t0, t1)
        if key in self._icp_cache:
            return self._icp_cache[key]
        filename = os.path.join(self.icp_path, key + ".npy")
        if os.path.exists(filename):
            M2 = np.load(filename)
        else:
            cam = self.store.raw_cam_poses(drive)
            p0, p1 = cam[t0], cam[t1]
            v2c = _velo2cam()
            # reference lib/data_loaders.py:494-496 (note the .T composition)
            M = (v2c @ p0.T @ np.linalg.inv(p1.T) @ np.linalg.inv(v2c)).T
            M2 = icp_refine_numpy(xyz0, xyz1, M, device=self.device)
            np.save(filename, M2)
        self._icp_cache[key] = M2
        return M2

    def __getitem__(self, idx):
        drive, t0, t1 = self.files[idx]
        xyz0 = self.store.xyz(drive, t0)
        xyz1 = self.store.xyz(drive, t1)
        M2 = self._icp_gt(drive, t0, t1, xyz0, xyz1)

        search = self.matching_search_voxel_size
        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, np.pi / 4)
            T1 = sample_random_trans(xyz1, self.randg, np.pi / 4)
            trans = T1 @ M2 @ np.linalg.inv(T0)
            xyz0 = apply_transform(xyz0, T0)
            xyz1 = apply_transform(xyz1, T1)
        else:
            trans = M2
        if self.random_scale and self.randg.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * self.randg.rand()
            search = search * scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
            # NOTE: the reference does NOT rescale trans[:3,3] here (unlike
            # the NFrame datasets, lib/data_loaders.py:529-534 vs :927-933)
            # — mirrored for parity.
        return {
            "xyz0": xyz0.astype(np.float32),
            "xyz1": xyz1.astype(np.float32),
            "T_gt": trans.astype(np.float32),
            "frame_distance": int(t1) - int(t0),
            "search_radius": float(search),
            "meta": (drive, int(t0), int(t1)),
        }


class KITTINMPairDataset(KITTIPairDataset):
    """Legacy metric-distance variant: first scan >= MIN_DIST meters ahead
    (reference lib/data_loaders.py:585-621 semantics folded into the legacy
    pair loop)."""

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        PairDatasetBase.__init__(self, phase, config, random_rotation, random_scale)
        self.root = config.kitti_root + "/dataset"
        self.store = KittiOdometryStore(self.root)
        self.icp_path = os.path.join(config.kitti_root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        self._icp_cache = {}
        if phase == "test":
            self.random_rotation = self.TEST_RANDOM_ROTATION
        min_dist = max(1.0, float(config.pair_min_dist))
        with open(_split_file(self.DATA_FILES[phase])) as f:
            subset_names = f.read().split()
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = sorted(self.store.scan_ids(drive_id))
            poses = self.store.poses(drive_id)
            Ts = poses[:, :3, 3]
            curr = 0
            while curr < len(inames) - 1:
                nxt = curr + 1
                while nxt < len(inames) and np.linalg.norm(
                        Ts[inames[nxt]] - Ts[inames[curr]]) < min_dist:
                    nxt += 1
                if nxt >= len(inames):
                    break
                self.files.append((drive_id, inames[curr], inames[nxt]))
                curr = nxt


# ---------------------------------------------------------- indoor datasets


class IndoorPairDataset(PairDatasetBase):
    """3DMatch-style npz fragment pairs (reference
    lib/data_loaders.py:194-303): pair lists come from per-scene
    `<scene>*%.2f.txt` overlap files under `threed_match_dir`; clouds from
    npz["pcd"]. Scale is applied BEFORE the random rotation and the GT is
    trans = T1 @ inv(T0) (fragments share a world frame)."""

    OVERLAP_RATIO: float = 0.3
    DATA_FILES = {
        "train": "train_3dmatch.txt",
        "val": "val_3dmatch.txt",
        "test": "test_3dmatch.txt",
    }

    def __init__(self, phase, config, random_rotation=True, random_scale=True):
        super().__init__(phase, config, random_rotation, random_scale)
        import glob

        self.root = config.threed_match_dir
        with open(_split_file(self.DATA_FILES[phase])) as f:
            subset_names = f.read().split()
        for name in subset_names:
            fname = name + "*%.2f.txt" % self.OVERLAP_RATIO
            fnames_txt = glob.glob(self.root + "/" + fname)
            assert len(fnames_txt) > 0, \
                f"Make sure that the path {self.root} has data {fname}"
            for fname_txt in fnames_txt:
                with open(fname_txt) as f:
                    content = f.readlines()
                for line in content:
                    parts = line.strip().split()
                    self.files.append((parts[0], parts[1]))

    def __getitem__(self, idx):
        file0 = os.path.join(self.root, self.files[idx][0])
        file1 = os.path.join(self.root, self.files[idx][1])
        xyz0 = np.load(file0)["pcd"].astype(np.float32)
        xyz1 = np.load(file1)["pcd"].astype(np.float32)
        search = self.matching_search_voxel_size
        if self.random_scale and self.randg.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * self.randg.rand()
            search = search * scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, self.rotation_range)
            T1 = sample_random_trans(xyz1, self.randg, self.rotation_range)
            trans = T1 @ np.linalg.inv(T0)
            xyz0 = apply_transform(xyz0, T0)
            xyz1 = apply_transform(xyz1, T1)
        else:
            trans = np.identity(4)
        return {
            "xyz0": xyz0.astype(np.float32),
            "xyz1": xyz1.astype(np.float32),
            "T_gt": trans.astype(np.float32),
            "frame_distance": 1,
            "search_radius": float(search),
            "meta": (0, idx, idx),
        }


class ThreeDMatchPairDataset(IndoorPairDataset):
    OVERLAP_RATIO = 0.3


class _Registry(dict):
    """Dataset name -> class, the JAX registry's names; any other name
    raises NotImplementedError."""

    def __missing__(self, name):
        raise NotImplementedError(
            f"dataset {name!r} is in neither package's registry: the port "
            f"has {sorted(self)}")


ALL_DATASETS = [
    KittiNFramePairDataset, NuscenesNFramePairDataset, WaymoNFramePairDataset,
    KittiRandDistPairDataset, NuscenesRandDistPairDataset,
    WaymoRandDistPairDataset, KittiContinuousFramePairDataset,
    NuscenesContinuousFramePairDataset, WaymoContinuousFramePairDataset,
    KITTIPairDataset, KITTINMPairDataset, ThreeDMatchPairDataset,
    SyntheticPairDataset, SyntheticContinuousPairDataset,
]
dataset_str_mapping = _Registry((d.__name__, d) for d in ALL_DATASETS)
