"""The port's 3DMatch readers (IndoorPairDataset, ThreeDMatchPairDataset)
against eyoc_tpu's on tests/test_datasets_golden.py:TestIndoor's tree
(sceneA: 3 npz fragments of 500 points, numpy seed 1, field `pcd`, one
`sceneA@seq-01-0.30.txt` overlap list), widened by a second scene with two
overlap lists (numpy seed 2) so that the glob and the list order are
exercised: the file lists, and at the readers' RandomState the items
(clouds, T_gt, search radius) bit for bit, train phase with and without
the random rotation (and with the random scale, drawn before the
rotation); and the port's `make_data_loader` batches equal to JAX's
(shuffled train batches of 2 with rotation and scale; the test phase).
"""

import numpy as np
import pytest
import torch

import eyoc_tpu.data.datasets as JD
import eyoc_tpu_torch.data.datasets as TD
from eyoc_tpu import config as jconfig
from eyoc_tpu.data import loader as jloader
from eyoc_tpu_torch import config as tconfig
from eyoc_tpu_torch.data import loader as tloader


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def indoor_tree(root):
    """TestIndoor's sceneA, and sceneB with two overlap lists."""
    root.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        np.savez(root / f"sceneA_{i}.npz",
                 pcd=rng.uniform(0, 3, (500, 3)).astype(np.float32),
                 color=np.ones((500, 3), np.float32))
    (root / "sceneA@seq-01-0.30.txt").write_text(
        "sceneA_0.npz sceneA_1.npz\nsceneA_1.npz sceneA_2.npz\n")
    rng = np.random.default_rng(2)
    for i in range(4):
        np.savez(root / f"sceneB_{i}.npz",
                 pcd=rng.uniform(-1, 2, (300 + 50 * i, 3)).astype(np.float32))
    (root / "sceneB@seq-01-0.30.txt").write_text("sceneB_0.npz sceneB_1.npz\n")
    (root / "sceneB@seq-02-0.30.txt").write_text(
        "sceneB_2.npz sceneB_3.npz\nsceneB_0.npz sceneB_3.npz\n")
    # another overlap ratio: not read
    (root / "sceneB@seq-02-0.50.txt").write_text("sceneB_1.npz sceneB_2.npz\n")
    return str(root)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    root = indoor_tree(tmp_path / "threedmatch")
    split = tmp_path / "split.txt"
    split.write_text("sceneA\nsceneB\n")
    monkeypatch.setattr(JD, "_split_file", lambda name: str(split))
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))
    return root


def configs(root, **over):
    argv = ["--threed_match_dir", root, "--voxel_size", "0.05",
            "--dataset", "ThreeDMatchPairDataset"]
    j = jconfig.Config(vars(jconfig.build_parser().parse_args(argv)))
    t = tconfig.Config(vars(tconfig.build_parser().parse_args(argv)))
    j.update(over)
    t.update(over)
    return j, t


def same_item(a, b):
    for k in ("xyz0", "xyz1", "T_gt"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for k in ("frame_distance", "search_radius", "meta"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("rotation,scale", [(True, False), (False, False),
                                            (True, True)])
@pytest.mark.parametrize("name", ["ThreeDMatchPairDataset",
                                  "IndoorPairDataset"])
def test_items_bit_equal(tree, name, rotation, scale):
    jc, tc = configs(tree)
    dj = getattr(JD, name)("train", jc, random_rotation=rotation,
                           random_scale=scale)
    dt = getattr(TD, name)("train", tc, random_rotation=rotation,
                           random_scale=scale)
    assert len(dt) == 5 and dj.files == dt.files
    for idx in (0, 3, 1, 4, 2, 0):
        same_item(dj[idx], dt[idx])
    if not rotation:
        assert np.array_equal(dt[0]["T_gt"], np.eye(4, dtype=np.float32))


def test_loader_batches_equal(tree):
    jc, tc = configs(tree, raw_point_capacity=512, use_random_scale=True)
    for phase, B in (("train", 2), ("test", 1)):
        lj = jloader.make_data_loader(jc, phase, B)
        lt = tloader.make_data_loader(tc, phase, B)
        assert len(lj) == len(lt) == 5 // B
        for bj, bt in zip(lj, lt):
            for x, y in zip(bj, bt):
                x = np.asarray(x)
                assert x.dtype == y.numpy().dtype
                assert np.array_equal(x, y.numpy())


def test_missing_overlap_list_raises(tmp_path, monkeypatch):
    root = indoor_tree(tmp_path / "threedmatch")
    split = tmp_path / "split.txt"
    split.write_text("sceneC\n")
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))
    _, tc = configs(root)
    with pytest.raises(AssertionError, match="sceneC"):
        TD.ThreeDMatchPairDataset("train", tc)


def test_split_files_copied():
    import os
    for name in ("train_3dmatch.txt", "val_3dmatch.txt", "test_3dmatch.txt"):
        with open(os.path.join(TD._ASSET_DIR, name)) as f:
            t = f.read()
        with open(os.path.join(JD._ASSET_DIR, name)) as f:
            assert f.read() == t and t.split()
