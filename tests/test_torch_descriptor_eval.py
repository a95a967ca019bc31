"""eyoc_tpu_torch.benchmarks.descriptor_eval against
eyoc_tpu.benchmarks.descriptor_eval on the CPU (the port's kernels by their
plain versions, JAX's SC2-PCR and ICP jitted as the harness calls them).

Both sides run with the same patched PRESETS["KITTI"]["max_points"] = 512
(the published 8000 would make every pair a [8000, 8000] problem and the
file slow; the harness pads every pair to that cap either way). The pairs
are tests/test_benchmarks.py:make_pairs's kind, at descriptor widths 16
(FCGF-like) and 33 (FPFH-like, normalised on load with the + 1e-6), made
from numpy seeds 0 and 3 (seed 3 with xyz1 perturbed by N(0, 5 cm) from
numpy seed 4, so that ICP moves the pose). `main` gives JAX's rr, n, f1,
precision and inlier_ratio exactly, and re / te within RE_TOL deg / TE_TOL
cm (f32 poses within 1e-4 m, and numpy's f32 arccos of the trace, which
steps by ~0.02 deg near 0), with and without --use_icp; after ICP's 30
rounds, whose f32 sums the two packages add in different orders, te within
TE_TOL_ICP cm (measured: 0.016 cm apart on the FCGF-16 pairs).
"""

import numpy as np
import pytest
import torch

from eyoc_tpu.benchmarks import descriptor_eval as J
from eyoc_tpu_torch.benchmarks import descriptor_eval as T

CAP = 512
RE_TOL = 0.05     # deg
TE_TOL = 0.02     # cm
TE_TOL_ICP = 0.05  # cm


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


def make_pairs(root, n_pairs=2, n_pts=400, noise=0.3, seed=0, width=16):
    """tests/test_benchmarks.py:make_pairs at descriptor width `width`."""
    rng = np.random.default_rng(seed)
    for i in range(n_pairs):
        xyz0 = rng.uniform(-20, 20, (n_pts, 3)).astype(np.float32)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.2, 1.0)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        t = rng.uniform(-5, 5, 3)
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = R.astype(np.float32)
        gt[:3, 3] = t.astype(np.float32)
        xyz1 = (xyz0 @ R.T + t).astype(np.float32)
        W = rng.normal(size=(3, width)).astype(np.float32)
        f0 = np.tanh(xyz0 @ W * 0.2)
        f1 = np.tanh(xyz0 @ W * 0.2)
        bad = rng.random(n_pts) < noise
        f0[bad] = rng.normal(size=(bad.sum(), width)).astype(np.float32)
        f0 /= np.linalg.norm(f0, axis=1, keepdims=True) + 1e-6
        f1 /= np.linalg.norm(f1, axis=1, keepdims=True) + 1e-6
        np.savez(root / f"pair_{i}.npz", xyz0=xyz0, xyz1=xyz1,
                 features0=f0, features1=f1, gt_trans=gt)


def perturb(root, seed=4):
    rng = np.random.default_rng(seed)
    for f in sorted(root.glob("pair_*.npz")):
        d = dict(np.load(f))
        d["xyz1"] = d["xyz1"] + rng.normal(0, 0.05, d["xyz1"].shape).astype(
            np.float32)
        np.savez(f, **d)


def same_result(a, b, te_tol=TE_TOL):
    for k in ("rr", "n", "f1", "precision", "inlier_ratio"):
        assert a[k] == b[k], k
    assert abs(a["re_deg"] - b["re_deg"]) <= RE_TOL
    assert abs(a["te_cm"] - b["te_cm"]) <= te_tol
    assert b["model_time"] > 0


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        trans = np.eye(4, dtype=np.float32)
        trans[:3, 3] = rng.normal(0, 0.2, 3)
        gt = np.eye(4, dtype=np.float32)
        src = rng.normal(size=(40, 3)).astype(np.float32)
        tgt = src + rng.normal(0, 0.1, src.shape).astype(np.float32)
        pred = rng.random(40) < 0.5
        for re, te in ((15.0, 30.0), (5.0, 60.0)):
            assert J.transformation_metrics(trans, gt, src, tgt, pred, re,
                                            te) == \
                T.transformation_metrics(trans, gt, src, tgt, pred, re, te)
        lab = rng.random(40) < 0.5
        assert J.classification_metrics(pred, lab) == \
            T.classification_metrics(pred, lab)
    assert J.classification_metrics(np.zeros(3), np.zeros(3)) == \
        T.classification_metrics(np.zeros(3), np.zeros(3))


@pytest.mark.parametrize("width,descriptor", [(16, "fcgf"), (33, "fpfh")])
@pytest.mark.parametrize("use_icp", [False, True])
def test_main_matches_jax(tmp_path, small_cap, width, descriptor, use_icp):
    seed = 3 if use_icp else 0
    make_pairs(tmp_path, seed=seed, width=width, noise=0.5 if use_icp else 0.3)
    if use_icp:
        perturb(tmp_path)
    argv = ["--root", str(tmp_path), "--dataset", "KITTI", "--descriptor",
            descriptor] + (["--use_icp"] if use_icp else [])
    want = J.main(argv)
    got = T.main(argv + ["--device", "cpu"])
    same_result(want, got, TE_TOL_ICP if use_icp else TE_TOL)
    assert got["n"] == 2 and got["rr"] == 100.0


def test_loader_bits_match_jax(tmp_path):
    make_pairs(tmp_path, width=33, seed=0)
    for desc in ("fcgf", "fpfh"):
        a = J.NpzPairLoader(str(tmp_path), desc).get_data(1)
        b = T.NpzPairLoader(str(tmp_path), desc).get_data(1)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_pair_above_the_cap_raises(tmp_path, small_cap, monkeypatch):
    """More keypoints than max_points: the port raises a ValueError naming
    the cap before any registration call (JAX fails later, on numpy
    broadcasting)."""
    make_pairs(tmp_path, n_pairs=1, n_pts=CAP + 1)
    called = []
    monkeypatch.setattr(T, "register_padded",
                        lambda *a, **k: called.append(1))
    with pytest.raises(ValueError, match=f"max_points {CAP}"):
        T.main(["--root", str(tmp_path), "--device", "cpu"])
    assert not called
    x = np.zeros((CAP, 3), np.float32)
    f = np.zeros((CAP, 8), np.float32)
    with pytest.raises(ValueError, match="target keypoints"):
        T.pad_pair(x, np.zeros((CAP + 1, 3), np.float32), f,
                   np.zeros((CAP + 1, 8), np.float32), CAP)
    x0, f0, m0, x1, f1, m1 = T.pad_pair(x[:10] + 1, x[:7] + 2, f[:10] + 3,
                                        f[:7] + 4, CAP)
    assert m0.sum() == 10 and m1.sum() == 7 and x0.shape == (CAP, 3)
    assert (x0[10:] == 0).all() and (f1[7:] == 0).all() and (f1[:7] == 4).all()


def test_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without --device the harness runs on the CUDA device, and with none
    it raises rather than run on the host."""
    make_pairs(tmp_path, n_pairs=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--root", str(tmp_path)])
