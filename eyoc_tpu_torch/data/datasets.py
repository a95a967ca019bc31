"""Pair datasets (counterpart of eyoc_tpu/data/datasets.py): the interface
of `PairDatasetBase` (:25-67) and the two synthetic datasets,
`SyntheticPairDataset` (:412) and `SyntheticContinuousPairDataset`
(:859-936), over the port's scene builder (`data/synthetic.py`, whose
clouds are bit-identical to the JAX package's for the same seed).

`__getitem__` returns raw augmented clouds and the ground-truth pose;
voxelization and the GT correspondences run on the device inside the
train step. The KITTI, nuScenes, Waymo and 3DMatch readers are not ported
(ROADMAP.md queue 1 item 6: their data is on no host of this project);
`dataset_str_mapping` raises NotImplementedError for their names.
"""

from __future__ import annotations

import numpy as np

from eyoc_tpu_torch.data.synthetic import SyntheticPairs, augment_pair


class PairDatasetBase:
    """Common state (reference PairDataset, lib/data_loaders.py:103-141)."""

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


class _Registry(dict):
    """Dataset name -> class; a name of the JAX registry that the port
    lacks raises NotImplementedError."""

    def __missing__(self, name):
        raise NotImplementedError(
            f"dataset {name!r} is not ported: the port has {sorted(self)}; "
            "the KITTI, nuScenes, Waymo and 3DMatch readers are ROADMAP.md "
            "queue 1 item 6")


dataset_str_mapping = _Registry(
    (d.__name__, d) for d in (SyntheticPairDataset,
                              SyntheticContinuousPairDataset))
