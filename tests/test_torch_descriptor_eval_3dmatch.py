"""The descriptor harness's 3DMatch paths, eyoc_tpu_torch against eyoc_tpu on
the CPU (the port's kernels by their plain versions):

- the per-scene gt.log protocol (`--scene_protocol`) with the Redwood
  trajectory benchmark (`--gt_benchmark_folder`) over two synthetic scenes
  of 3 fragments (tests/test_benchmarks.py:make_3dmatch_scene's kind,
  numpy seeds 0 and 1, FCGF-16 and FPFH-33 descriptors; THREEDMATCH_SCENES
  patched to the two names on both sides): rr, pair_rr, n, f1, precision
  and the benchmark's precision / recall exactly, re / te within RE_TOL deg
  / TE_TOL cm, as in test_torch_descriptor_eval.py;
- the 3DLoMatch pickle index (`--lomatch_pkl`) over the same tree: the same;
- the predator branch's importance subsampling: the loaders' outputs
  bit-equal (np.random.default_rng([seed, i]) on both sides), with picks
  (clouds above num_node) and without.

Both sides take PRESETS[...]["max_points"] = 512 (the published 8000 would
only pad these 300-point fragments further).
"""

import pickle

import numpy as np
import pytest
import torch

from eyoc_tpu.benchmarks import descriptor_eval as J
from eyoc_tpu_torch.benchmarks import descriptor_eval as T
from eyoc_tpu_torch.benchmarks.gtlog import write_gt_log
from test_torch_descriptor_eval import RE_TOL, TE_TOL
from test_torch_gtlog import rand_pose, write_info

CAP = 512
SCENES = ["sceneA", "sceneB"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_cap(monkeypatch):
    for mod in (J, T):
        for preset in mod.PRESETS.values():
            monkeypatch.setitem(preset, "max_points", CAP)
        monkeypatch.setattr(mod, "THREEDMATCH_SCENES", SCENES)


def scene_tree(root, scene, seed, descriptor, width, n_frag=3, n_pts=300):
    """Fragments of one world in `n_frag` random frames, with descriptors a
    smooth function of the world position; gt.log (target->source, as
    3DMatch stores it) and gt.info under gt_result/, and under
    bench/<scene>/ for the trajectory benchmark a gt.log of the src->tgt
    poses (the convention it compares the harness's poses in) and the
    gt.info."""
    rng = np.random.default_rng(seed)
    frag = root / "fragments" / scene
    gt_dir = root / "gt_result" / f"{scene}-evaluation"
    bench = root / "bench" / scene
    for d in (frag, gt_dir, bench):
        d.mkdir(parents=True)
    world = rng.uniform(0, 3, (n_pts, 3)).astype(np.float32)
    W = rng.normal(size=(3, width)).astype(np.float32)
    feat = np.tanh(world @ W)
    if descriptor == "fcgf":
        feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6
    else:
        feat = np.abs(feat) * 50.0         # FPFH histograms, unnormalised
    poses = [rand_pose(rng) for _ in range(n_frag)]
    for fid, P in enumerate(poses):
        xyz = (world @ P[:3, :3].T + P[:3, 3]).astype(np.float32)
        np.savez(frag / f"cloud_bin_{fid}_{descriptor}.npz", xyz=xyz,
                 feature=feat)
    pairs = [(i, j, n_frag) for i in range(n_frag)
             for j in range(i + 1, n_frag)]
    traj = [np.linalg.inv(poses[j] @ np.linalg.inv(poses[i]))
            for i, j, _ in pairs]
    cov = [np.eye(6) * 300.0 for _ in pairs]
    write_gt_log(gt_dir / "gt.log", pairs, traj)
    write_info(gt_dir / "gt.info", pairs, cov)
    # benchmark_trajectories scores the harness's src->tgt poses against
    # its gt.log as they are (both packages): that tree holds src->tgt
    write_gt_log(bench / "gt.log", pairs, [np.linalg.inv(P) for P in traj])
    write_info(bench / "gt.info", pairs, cov)
    return pairs, traj


def same(a, b, keys):
    for k in keys:
        assert a[k] == b[k], k
    assert abs(a["re_deg"] - b["re_deg"]) <= RE_TOL
    assert abs(a["te_cm"] - b["te_cm"]) <= TE_TOL


@pytest.mark.parametrize("descriptor,width", [("fcgf", 16), ("fpfh", 33)])
def test_scene_protocol_matches_jax(tmp_path, small_cap, descriptor, width):
    for s, seed in zip(SCENES, (0, 1)):
        scene_tree(tmp_path, s, seed, descriptor, width)
    argv = ["--root", str(tmp_path), "--dataset", "3DMatch", "--descriptor",
            descriptor, "--scene_protocol", "--gt_benchmark_folder",
            str(tmp_path / "bench")]
    want = J.main(argv)
    got = T.main(argv + ["--device", "cpu"])
    same(want, got, ("rr", "pair_rr", "n"))
    assert got["n"] == 6 and got["rr"] == 100.0
    for sw, sg in zip(want["scenes"], got["scenes"]):
        same(sw, sg, ("scene", "rr", "n", "f1", "precision", "inlier_ratio"))
    tw, tg = want["trajectory"], got["trajectory"]
    for k in ("mean_precision", "mean_recall", "weighted_recall"):
        assert tw[k] == tg[k], k
    assert tg["mean_recall"] == 1.0
    for rw, rg in zip(tw["scenes"], tg["scenes"]):
        for k in ("scene", "precision", "recall", "n_valid"):
            assert rw[k] == rg[k], k
        assert abs(rw["re_deg"] - rg["re_deg"]) <= RE_TOL
        assert abs(rw["te_m"] - rg["te_m"]) <= TE_TOL / 100


def lomatch_index(root):
    """A 3DLoMatch.pkl over the scene tree: every pair of each scene, with
    the gt.log's target->source transform inverted (src -> tgt)."""
    infos = {"rot": [], "trans": [], "src": [], "tgt": []}
    for s, seed in zip(SCENES, (0, 1)):
        pairs, traj = scene_tree(root, s, seed, "fcgf", 16)
        for (i, j, _), P in zip(pairs, traj):
            G = np.linalg.inv(P)
            infos["rot"].append(G[:3, :3])
            infos["trans"].append(G[:3, 3:])
            infos["src"].append(f"3DLoMatch/{s}/cloud_bin_{i}.pth")
            infos["tgt"].append(f"3DLoMatch/{s}/cloud_bin_{j}.pth")
    path = root / "3DLoMatch.pkl"
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def test_lomatch_index_matches_jax(tmp_path, small_cap):
    pkl = lomatch_index(tmp_path)
    argv = ["--root", str(tmp_path), "--dataset", "3DLoMatch",
            "--descriptor", "fcgf", "--lomatch_pkl", str(pkl),
            "--gt_benchmark_folder", str(tmp_path / "bench")]
    want = J.main(argv)
    got = T.main(argv + ["--device", "cpu"])
    same(want, got, ("rr", "n", "f1", "precision", "inlier_ratio"))
    assert got["n"] == 6 and got["rr"] == 100.0
    for k in ("mean_precision", "mean_recall", "weighted_recall"):
        assert want["trajectory"][k] == got["trajectory"][k], k


def test_predator_picks_bit_equal(tmp_path):
    rng = np.random.default_rng(7)
    n_pairs = 3
    infos = {"rot": [], "trans": [], "src": [], "tgt": []}
    for i in range(n_pairs):
        P = rand_pose(rng)
        infos["rot"].append(P[:3, :3])
        infos["trans"].append(P[:3, 3])
        infos["src"].append(f"3DLoMatch/s/cloud_bin_{i}.pth")
        infos["tgt"].append(f"3DLoMatch/s/cloud_bin_{i + 1}.pth")
        n_src, n_tgt = (120, 90) if i < 2 else (40, 30)
        n = n_src + n_tgt
        torch.save({"len_src": n_src,
                    "pcd": torch.from_numpy(rng.normal(size=(n, 3))),
                    "feats": torch.from_numpy(rng.normal(size=(n, 32))),
                    "saliency": torch.from_numpy(rng.random((n, 1))),
                    "overlaps": torch.from_numpy(rng.random((n, 1)))},
                   tmp_path / f"{i}.pth")
    pkl = tmp_path / "index.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    for seed in (51, 52):
        a = J.ThreeDLoMatchPklLoader(str(tmp_path), str(pkl), "predator",
                                     num_node=64, seed=seed)
        b = T.ThreeDLoMatchPklLoader(str(tmp_path), str(pkl), "predator",
                                     num_node=64, seed=seed)
        assert len(a) == len(b) == n_pairs
        for i in (2, 0, 1):          # the picks do not depend on the order
            out_a, out_b = a.get_data(i), b.get_data(i)
            for x, y in zip(out_a, out_b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert len(out_b[0]) == (64 if i < 2 else 40)
