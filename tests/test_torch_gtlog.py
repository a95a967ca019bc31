"""eyoc_tpu_torch.benchmarks.gtlog against eyoc_tpu.benchmarks.gtlog (both
numpy): on a synthetic gt tree made from numpy seeds 0-2 (3 scenes of 4-6
fragments, random poses, covariances A Aᵀ + 10 I), the writer's bytes, the
readers' arrays, mat2quat, transformation_err, evaluate_registration and
benchmark_trajectories are bit-equal (poses perturbed so that some pairs
fail the Redwood test, and one scene with no non-consecutive pair)."""

import os

import numpy as np
import pytest
import torch

from eyoc_tpu.benchmarks import gtlog as J
from eyoc_tpu_torch.benchmarks import gtlog as T


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_pose(rng, max_t=1.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.05, 3.0)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    P = np.eye(4)
    P[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    P[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return P


def write_info(path, pairs, cov):
    with open(path, "w") as f:
        for (i, j, n), C in zip(pairs, cov):
            f.write(f"{i}\t{j}\t{n}\n")
            for r in range(6):
                f.write(" ".join(f"{v:.10e}" for v in C[r]) + "\n")


def gt_tree(root, writer):
    """<root>/<scene>/gt.log + gt.info for 3 scenes (numpy seeds 0-2);
    scene 2 has only consecutive pairs. Returns {scene: (pairs, traj)}."""
    out = {}
    for s, n_frag in enumerate((5, 6, 2)):
        rng = np.random.default_rng(s)
        d = root / f"scene{s}"
        d.mkdir(parents=True)
        pairs = np.asarray([(i, j, n_frag) for i in range(n_frag)
                            for j in range(i + 1, n_frag)])
        traj = np.stack([rand_pose(rng) for _ in pairs])
        A = rng.normal(size=(len(pairs), 6, 6))
        cov = A @ A.transpose(0, 2, 1) + 10 * np.eye(6)
        writer(d / "gt.log", pairs, traj)
        write_info(d / "gt.info", pairs, cov)
        out[f"scene{s}"] = (pairs, traj)
    return out


def test_writer_and_readers_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    pairs = np.asarray([(0, 2, 5), (1, 4, 5), (3, 4, 5)])
    traj = np.stack([rand_pose(rng) for _ in pairs])
    J.write_gt_log(tmp_path / "j.log", pairs, traj)
    T.write_gt_log(tmp_path / "t.log", pairs, traj)
    assert (tmp_path / "j.log").read_bytes() == (tmp_path / "t.log").read_bytes()
    pj, tj = J.read_gt_log(tmp_path / "j.log")
    pt, tt = T.read_gt_log(tmp_path / "t.log")
    assert pj.dtype == pt.dtype and np.array_equal(pj, pt)
    assert tj.dtype == tt.dtype and np.array_equal(tj, tt)
    np.testing.assert_array_equal(pt, pairs)
    np.testing.assert_allclose(tt, traj, atol=1e-7)     # %.8e round trip
    tree = gt_tree(tmp_path / "gt", T.write_gt_log)
    for scene in tree:
        info = tmp_path / "gt" / scene / "gt.info"
        nj, cj = J.read_gt_info(info)
        nt, ct = T.read_gt_info(info)
        assert nj == nt and np.array_equal(cj, ct)


def test_mat2quat_and_transformation_err_bit_equal():
    rng = np.random.default_rng(3)
    for _ in range(50):
        P = rand_pose(rng)
        qj, qt = J.mat2quat(P[:3, :3]), T.mat2quat(P[:3, :3])
        assert np.array_equal(qj, qt) and qt[0] >= 0
        A = rng.normal(size=(6, 6))
        info = A @ A.T + np.eye(6)
        assert J.transformation_err(P, info) == T.transformation_err(P, info)


def test_evaluate_registration_and_benchmark_bit_equal(tmp_path):
    root = tmp_path / "gt"
    tree = gt_tree(root, J.write_gt_log)
    rng = np.random.default_rng(9)
    est = []
    for scene, (pairs, traj) in tree.items():
        pj, tj = J.read_gt_log(root / scene / "gt.log")
        n_frag, cov = J.read_gt_info(root / scene / "gt.info")
        e = tj.copy()
        # a third of the poses off by a few cm, a third far off
        for k in range(len(e)):
            if k % 3 == 1:
                e[k, :3, 3] += rng.normal(0, 0.05, 3)
            elif k % 3 == 2:
                e[k] = rand_pose(rng, max_t=3.0)
        for err2 in (0.2, 0.05):
            a = J.evaluate_registration(n_frag, e, pj, pj, tj, cov, err2)
            b = T.evaluate_registration(n_frag, e, pj, pj, tj, cov, err2)
            assert a == b
        est.append(e)
    est = np.concatenate(est)
    lj, lt = [], []
    rj = J.benchmark_trajectories(est, str(root), log=lj.append)
    rt = T.benchmark_trajectories(est, str(root), log=lt.append)
    assert lj == lt
    assert sorted(os.listdir(root)) == [r["scene"] for r in rt["scenes"]]
    np.testing.assert_equal(rj, rt)          # NaN == NaN for scene 2
    assert 0.0 < rt["mean_recall"] < 1.0
