"""3DMatch/Redwood gt.log trajectory protocol (a copy of
eyoc_tpu/benchmarks/gtlog.py: numpy only, the same bits).

Re-derivation of the reference's trajectory utilities
(reference scripts/SC2_PCR/benchmark_utils_predator.py:56-231, originally
the Redwood indoor-registration evaluation): gt.log / gt.info readers, the
covariance-weighted transformation error, and the registration
precision/recall over non-consecutive fragment pairs. Pure numpy
(nibabel's mat2quat is inlined).

Formats (http://redwood-data.org/indoor/fileformat.html):
  gt.log:  blocks of 5 lines: "i j n_fragments" then the 4x4 matrix rows.
  gt.info: blocks of 7 lines: "i j n_fragments" then the 6x6 covariance.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np


def mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z], w >= 0
    (nibabel.quaternions.mat2quat convention, used by the reference's
    computeTransformationErr)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def transformation_err(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted squared error of a relative transform —
    approximates the RMSE of GT correspondences (reference
    benchmark_utils_predator.py:56-76)."""
    t = trans[:3, 3]
    q = mat2quat(trans[:3, :3])
    er = np.concatenate([t, q[1:]], axis=0)
    return float((er.reshape(1, 6) @ info @ er.reshape(6, 1))[0, 0]
                 / info[0, 0])


def read_gt_log(filename: str):
    """Returns (pairs [n, 3] int array of (i, j, n_fragments),
    traj [n, 4, 4]) — reference read_trajectory (:78-115)."""
    with open(filename) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    n = len(lines) // 5
    pairs = np.zeros((n, 3), np.int64)
    traj = np.zeros((n, 4, 4))
    for k in range(n):
        pairs[k] = [int(v) for v in lines[5 * k].split()[:3]]
        for r in range(4):
            traj[k, r] = np.fromstring(lines[5 * k + 1 + r], sep=" \t")[:4]
    return pairs, traj


def write_gt_log(filename: str, pairs, traj) -> None:
    """Inverse of read_gt_log (for fixtures and est.log dumps)."""
    with open(filename, "w") as f:
        for (i, j, n), T in zip(pairs, traj):
            f.write(f"{int(i)}\t{int(j)}\t{int(n)}\t\n")
            for r in range(4):
                f.write("\t".join(f"{v:.8e}" for v in T[r]) + "\t\n")


def read_gt_info(filename: str):
    """Returns (n_fragments, cov [n, 6, 6]) — reference
    read_trajectory_info (:118-148)."""
    with open(filename) as f:
        contents = [ln for ln in f.readlines() if ln.strip()]
    n_pairs = len(contents) // 7
    assert len(contents) == 7 * n_pairs, "malformed gt.info"
    n_frame = 0
    info = np.zeros((n_pairs, 6, 6))
    for i in range(n_pairs):
        _, _, n_frame = (int(v) for v in contents[i * 7].split()[:3])
        for r in range(6):
            info[i, r] = np.fromstring(contents[i * 7 + 1 + r], sep=" \t")[:6]
    return n_frame, info


def evaluate_registration(num_fragment, result, result_pairs, gt_pairs, gt,
                          gt_info, err2: float = 0.2):
    """Redwood registration precision/recall over NON-consecutive fragment
    pairs (reference :174-231). err2 is the RMSE threshold in meters
    (squared internally, like the reference).

    Returns (precision, recall, flags) where flags[i] is 0=good, 1=bad,
    2=pair not in the gt non-consecutive set."""
    err2 = err2 ** 2
    gt_mask = np.zeros((num_fragment, num_fragment), np.int64)
    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if j - i > 1:  # only non-consecutive pairs are scored
            gt_mask[i, j] = idx
    n_gt = int(np.sum(gt_mask > 0))

    good = n_res = 0
    flags = []
    for idx in range(result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        if gt_mask[i, j] > 0:
            n_res += 1
            gt_idx = gt_mask[i, j]
            p = transformation_err(
                np.linalg.inv(gt[gt_idx]) @ result[idx], gt_info[gt_idx])
            if p <= err2:
                good += 1
                flags.append(0)
            else:
                flags.append(1)
        else:
            flags.append(2)
    precision = good / n_res if n_res else 0.0
    recall = good / max(n_gt, 1)
    return precision, recall, flags


def _rot_err_deg(R1, R2):
    tr = np.clip((np.trace(R1.T @ R2) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(tr)))


def benchmark_trajectories(pred_poses: np.ndarray, gt_folder: str,
                           log=print):
    """Scene-table benchmark over a gt folder tree (reference
    benchmark_predator, test_3DLoMatch.py:122-180): per scene, Redwood
    precision/recall + mean/median RE/TE over the good pairs.

    pred_poses: [sum(n_pairs_scene), 4, 4] in the scenes' sorted order.
    Returns dict with per-scene rows and the weighted means.
    """
    scenes = sorted(os.listdir(gt_folder))
    rows = []
    re_all, te_all, precisions, recalls, n_valids = [], [], [], [], []
    start = 0
    for scene in scenes:
        path = os.path.join(gt_folder, scene)
        gt_pairs, gt_traj = read_gt_log(os.path.join(path, "gt.log"))
        n_frag, gt_cov = read_gt_info(os.path.join(path, "gt.info"))
        n_valid = int(sum(abs(int(a) - int(b)) > 1 for a, b, _ in gt_pairs))
        est = pred_poses[start: start + len(gt_pairs)]
        start += len(gt_pairs)
        prec, rec, flags = evaluate_registration(
            n_frag, est, gt_pairs, gt_pairs, gt_traj, gt_cov)
        good = np.asarray(flags) == 0
        re = [_rot_err_deg(gt_traj[k, :3, :3], est[k, :3, :3])
              for k in range(len(est)) if good[k]]
        te = [float(np.linalg.norm(gt_traj[k, :3, 3] - est[k, :3, 3]))
              for k in range(len(est)) if good[k]]
        rows.append(dict(scene=scene, precision=prec, recall=rec,
                         re_deg=float(np.mean(re)) if re else float("nan"),
                         te_m=float(np.mean(te)) if te else float("nan"),
                         n_valid=n_valid))
        re_all += re
        te_all += te
        precisions.append(prec)
        recalls.append(rec)
        n_valids.append(n_valid)
        log(f"{scene}: prec {prec:.3f} recall {rec:.3f} "
            f"re {rows[-1]['re_deg']:.3f} te {rows[-1]['te_m']:.3f} "
            f"({n_valid} valid)")

    w = np.asarray(n_valids, float)
    w = w / max(w.sum(), 1.0)
    out = dict(
        scenes=rows,
        mean_precision=float(np.mean(precisions)) if precisions else 0.0,
        mean_recall=float(np.mean(recalls)) if recalls else 0.0,
        weighted_recall=float(np.sum(w * np.asarray(recalls))) if recalls else 0.0,
        mean_re_deg=float(np.mean(re_all)) if re_all else float("nan"),
        mean_te_m=float(np.mean(te_all)) if te_all else float("nan"),
    )
    log(f"Mean registration recall {out['mean_recall']:.4f} "
        f"(weighted {out['weighted_recall']:.4f}), "
        f"precision {out['mean_precision']:.4f}")
    return out
