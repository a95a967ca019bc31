"""SC2-PCR precomputed-descriptor benchmark harness (counterpart of
eyoc_tpu/benchmarks/descriptor_eval.py: the same file formats, presets,
flags and metrics).

The vendored reference harness (reference scripts/SC2_PCR/test_KITTI.py:
18-151, dataset.py:193-241, evaluate_metric.py:12-112) is the only in-tree
path to the published numbers (KITTI+FCGF RR 98.20 / RE 0.33 deg /
TE 20.95 cm, scripts/SC2_PCR/README.md:132-135): it drives the Matcher
over directories of .npz files holding precomputed keypoints/descriptors.
Here the registration is the port's `sc2_pcr_estimator` on the card (K2's
feature 1-NN, then K3, K13, K4, K14 and K15), with `--use_icp` the port's
`icp_point_to_point` after it (K2 and `icp_solve` a round).

Usage:
    python -m eyoc_tpu_torch.benchmarks.descriptor_eval \
        --root /data/SC2_PCR/KITTI --dataset KITTI --descriptor fcgf
    (--device cpu runs the plain versions on the host)

npz fields (reference dataset.py:218-231): xyz0, xyz1, features0,
features1, gt_trans. FPFH descriptors are L2-normalized on load.

Each pair is padded to the preset's `max_points` rows with a mask. A cloud
of more keypoints raises ValueError before anything is launched: the JAX
harness truncates the padded rows but then fails on numpy broadcasting
(its metrics take the full cloud), and the port does not subsample, which
would be a feature the JAX harness lacks.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

# dataset presets mirror reference scripts/SC2_PCR/config_json/*.json
PRESETS = {
    "KITTI": dict(d_thre=0.1, num_iterations=20, ratio=0.2, nms_radius=0.6,
                  max_points=8000, k1=30, k2=20, inlier_threshold=0.6,
                  re_thre=5.0, te_thre=60.0),
    "3DMatch": dict(d_thre=0.1, num_iterations=10, ratio=0.2, nms_radius=0.1,
                    max_points=8000, k1=30, k2=20, inlier_threshold=0.1,
                    re_thre=15.0, te_thre=30.0),
    "3DLoMatch": dict(d_thre=0.1, num_iterations=10, ratio=0.2, nms_radius=0.1,
                      max_points=8000, k1=30, k2=20, inlier_threshold=0.1,
                      re_thre=15.0, te_thre=30.0),
}


def _unit_rows(f):
    """FPFH's L2 normalisation (reference dataset.py:225-226)."""
    return f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-6)


class NpzPairLoader:
    """reference dataset.py:193-241 (KITTILoader): one .npz per pair."""

    def __init__(self, root: str, descriptor: str = "fcgf"):
        assert descriptor in ("fcgf", "fpfh")
        self.descriptor = descriptor
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith(".npz"))

    def __len__(self):
        return len(self.files)

    def get_data(self, i: int):
        data = np.load(self.files[i])
        f0 = data["features0"].astype(np.float32)
        f1 = data["features1"].astype(np.float32)
        if self.descriptor == "fpfh":
            f0, f1 = _unit_rows(f0), _unit_rows(f1)
        return (data["xyz0"].astype(np.float32),
                data["xyz1"].astype(np.float32), f0, f1,
                data["gt_trans"].astype(np.float32))


THREEDMATCH_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]


def _fragment(root: str, scene: str, fid, descriptor: str):
    """One fragment's (xyz, feature) from the 3DMatch fragment tree."""
    data = np.load(os.path.join(root, "fragments", scene,
                                f"cloud_bin_{fid}_{descriptor}.npz"))
    f = data["feature"].astype(np.float32)
    if descriptor == "fpfh":
        f = _unit_rows(f)
    return data["xyz"].astype(np.float32), f


class ThreeDMatchSceneLoader:
    """Per-scene gt.log-driven fragment pairs (reference ThreeDLoader,
    scripts/SC2_PCR/dataset.py:8-103): pairs come from
    `{root}/gt_result/{scene}-evaluation/gt.log`, fragments from
    `{root}/fragments/{scene}/cloud_bin_{id}_{descriptor}.npz`
    (fields xyz, feature); the stored transform is target->source and is
    inverted on load (dataset.py:78)."""

    def __init__(self, root: str, scene: str, descriptor: str = "fcgf"):
        from eyoc_tpu_torch.benchmarks.gtlog import read_gt_log

        assert descriptor in ("fcgf", "fpfh")
        self.root, self.scene, self.descriptor = root, scene, descriptor
        self.pairs, self.traj = read_gt_log(
            os.path.join(root, "gt_result", f"{scene}-evaluation", "gt.log"))

    def __len__(self):
        return len(self.pairs)

    def get_data(self, i: int):
        src_id, tgt_id = int(self.pairs[i, 0]), int(self.pairs[i, 1])
        x0, f0 = _fragment(self.root, self.scene, src_id, self.descriptor)
        x1, f1 = _fragment(self.root, self.scene, tgt_id, self.descriptor)
        gt = np.linalg.inv(self.traj[i]).astype(np.float32)
        return x0, x1, f0, f1, gt


class ThreeDLoMatchPklLoader:
    """3DLoMatch pairs from the predator-style pickle index (reference
    ThreeDLoMatchLoader, dataset.py:105-191): `3DLoMatch.pkl` holds
    rot/trans/src/tgt; fcgf/fpfh descriptors load from the 3DMatch
    fragment tree; descriptor='predator' loads per-pair .pth dumps."""

    def __init__(self, root: str, pkl_path: str, descriptor: str = "fcgf",
                 num_node: int = 5000, seed: int = 51):
        import pickle

        assert descriptor in ("fcgf", "fpfh", "predator")
        self.root, self.descriptor, self.num_node = root, descriptor, num_node
        # the predator importance subsampling is the only stochastic step;
        # it is keyed per (seed, pair index), as the JAX loader keys it, so
        # runs pick the same rows whatever the evaluation order
        self.seed = seed
        with open(pkl_path, "rb") as f:
            self.infos = pickle.load(f)

    def __len__(self):
        return len(self.infos["rot"])

    def get_data(self, i: int):
        rot = np.asarray(self.infos["rot"][i], np.float32)
        t = np.asarray(self.infos["trans"][i], np.float32).reshape(3)
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3], gt[:3, 3] = rot, t
        if self.descriptor == "predator":
            import torch

            d = torch.load(os.path.join(self.root, f"{i}.pth"),
                           map_location="cpu", weights_only=False)
            n_src = int(d["len_src"])
            pcd = d["pcd"].numpy().astype(np.float32)
            feats = d["feats"].numpy().astype(np.float32)
            sal = d["saliency"].numpy().ravel()
            ovl = d["overlaps"].numpy().ravel()

            rng = np.random.default_rng([self.seed, i])

            def pick(x, f, score):
                if len(x) <= self.num_node:
                    return x, f
                p = score / score.sum()
                idx = rng.choice(len(x), self.num_node,
                                 replace=False, p=p)
                return x[idx], f[idx]

            x0, f0 = pick(pcd[:n_src], feats[:n_src], sal[:n_src] * ovl[:n_src])
            x1, f1 = pick(pcd[n_src:], feats[n_src:], sal[n_src:] * ovl[n_src:])
            return x0, x1, f0, f1, gt
        scene = self.infos["src"][i].split("/")[1]
        sid = self.infos["src"][i].split("/")[-1].split("_")[-1].replace(".pth", "")
        tid = self.infos["tgt"][i].split("/")[-1].split("_")[-1].replace(".pth", "")
        x0, f0 = _fragment(self.root, scene, sid, self.descriptor)
        x1, f1 = _fragment(self.root, scene, tid, self.descriptor)
        return x0, x1, f0, f1, gt


def eval_3dmatch(root: str, dataset: str = "3DMatch",
                 descriptor: str = "fcgf", scenes=None, num_pairs: int = -1,
                 gt_benchmark_folder: str | None = None,
                 use_icp: bool = False, device=None):
    """Scene-grouped 3DMatch evaluation (reference test_3DMatch.py:82-160):
    per-scene stats, RE/TE averaged over the successful pairs of each
    scene, Mean Reg Recall = mean over SCENES of per-scene RR; plus the
    pair-level aggregate. If `gt_benchmark_folder` (gt.log + gt.info per
    scene, reference benchmarks/3DLoMatch fixture layout) is given, also
    runs the Redwood trajectory benchmark on the estimated poses."""
    scenes = scenes or THREEDMATCH_SCENES
    per_scene = []
    all_poses = []
    pair_rr_num = pair_n = 0
    for scene in scenes:
        loader = ThreeDMatchSceneLoader(root, scene, descriptor)
        res = eval_descriptor_pairs(loader, dataset, num_pairs,
                                    collect_poses=all_poses, use_icp=use_icp,
                                    device=device)
        per_scene.append(dict(scene=scene, **res))
        pair_rr_num += res["rr"] * res["n"] / 100.0
        pair_n += res["n"]
        logging.info(
            f"Scene {scene}: RR {res['rr']:.2f}% RE {res['re_deg']:.2f} "
            f"TE {res['te_cm']:.2f} ({res['n']} pairs)")
    out = dict(
        scenes=per_scene,
        rr=float(np.mean([s["rr"] for s in per_scene])),   # scene-averaged
        pair_rr=100.0 * pair_rr_num / max(pair_n, 1),
        re_deg=float(np.nanmean([s["re_deg"] for s in per_scene])),
        te_cm=float(np.nanmean([s["te_cm"] for s in per_scene])),
        n=pair_n,
    )
    logging.info(
        f"All {len(per_scene)} scenes: Mean Reg Recall {out['rr']:.2f}% "
        f"(pair-level {out['pair_rr']:.2f}%), RE {out['re_deg']:.2f} deg, "
        f"TE {out['te_cm']:.2f} cm")
    if gt_benchmark_folder:
        from eyoc_tpu_torch.benchmarks.gtlog import benchmark_trajectories

        out["trajectory"] = benchmark_trajectories(
            np.asarray(all_poses), gt_benchmark_folder, log=logging.info)
    return out


def transformation_metrics(trans, gt_trans, src_corr, tgt_corr,
                           pred_labels, re_thre=15.0, te_thre=30.0):
    """reference evaluate_metric.py:12-64 (TransformationLoss), numpy.

    Returns dict(recall 0/100, re_deg, te_cm, rmse)."""
    R, t = trans[:3, :3], trans[:3, 3]
    gR, gt_ = gt_trans[:3, :3], gt_trans[:3, 3]
    re = np.degrees(np.arccos(np.clip((np.trace(R.T @ gR) - 1) / 2, -1, 1)))
    te = float(np.linalg.norm(t - gt_)) * 100.0
    warp = src_corr @ R.T + t
    rmse = float(np.linalg.norm(warp - tgt_corr, axis=-1).mean())
    recall = 100.0 if (te < te_thre and re < re_thre) else 0.0
    return dict(recall=recall, re_deg=float(re), te_cm=te, rmse=rmse)


def classification_metrics(pred_labels, gt_labels):
    """reference evaluate_metric.py:66-112 (ClassificationLoss), numpy:
    inlier precision / recall / F1 of the predicted inlier set."""
    pred = np.asarray(pred_labels) > 0
    gt = np.asarray(gt_labels) > 0
    tp = float(np.sum(pred & gt))
    precision = tp / max(1.0, float(np.sum(pred)))
    recall = tp / max(1.0, float(np.sum(gt)))
    f1 = 2 * precision * recall / max(1e-12, precision + recall)
    return dict(inlier_precision=precision, inlier_recall=recall, f1=f1)


def sc2_config(dataset: str):
    """The preset's SC2PCRConfig: seed_cap = int(max_points * ratio)."""
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig

    preset = PRESETS[dataset]
    cap = preset["max_points"]
    return SC2PCRConfig(
        d_thre=preset["d_thre"], num_iterations=preset["num_iterations"],
        ratio=preset["ratio"], nms_radius=preset["nms_radius"],
        max_points=cap, k1=preset["k1"], k2=preset["k2"],
        inlier_threshold=preset["inlier_threshold"],
        seed_cap=int(cap * preset["ratio"]))


def pad_pair(x0, x1, f0, f1, cap: int):
    """A pair's rows padded to `cap` with zeros: numpy (x0, f0, m0, x1,
    f1, m1), as the JAX harness's `pad`. Raises ValueError for a cloud of
    more than `cap` rows."""
    for name, x in (("source", x0), ("target", x1)):
        if len(x) > cap:
            raise ValueError(f"{len(x)} {name} keypoints exceed the preset's "
                             f"max_points {cap}")
    out = []
    for x, f in ((x0, f0), (x1, f1)):
        xp = np.zeros((cap, 3), np.float32)
        xp[: len(x)] = x
        fp = np.zeros((cap, f.shape[1]), np.float32)
        fp[: len(f)] = f
        out += [xp, fp, np.arange(cap) < len(x)]
    return tuple(out)


def register_padded(x0, f0, m0, x1, f1, m1, cfg, use_icp: bool = False):
    """The harness's registration of one padded pair (tensors on one
    device): `sc2_pcr_estimator`, then with `use_icp` point-to-point ICP
    from its pose at 0.10 m, 30 rounds (Open3D registration_icp's default
    max_iteration). Returns (trans [4, 4], labels [cap], nn [cap])."""
    from eyoc_tpu_torch.registration.icp import icp_point_to_point
    from eyoc_tpu_torch.registration.sc2pcr import sc2_pcr_estimator

    trans, labels, _, nn = sc2_pcr_estimator(x0, f0, m0, x1, f1, m1, cfg)
    if use_icp:
        trans, _, _ = icp_point_to_point(x0, m0, x1, m1, trans,
                                         max_corr_dist=0.10, iterations=30)
    return trans, labels, nn


def eval_descriptor_pairs(loader, dataset: str = "KITTI",
                          num_pairs: int = -1, log_every: int = 50,
                          collect_poses: list | None = None,
                          use_icp: bool = False, device=None):
    """Run the full per-pair protocol (reference test_KITTI.py:18-102) on
    the card (or `device`).

    use_icp: point-to-point ICP post-refinement of the estimated pose on
    the keypoint clouds at 0.10 m correspondence distance (reference
    `icp_refine`, scripts/SC2_PCR/benchmark_utils.py:40-56, enabled by
    test_KITTI.py:127 `--use_icp`). `model_time` is the host clock from
    the pair's padding (`pad_pair`, on the host, as JAX's clock starts
    before its `pad`) until its results are back on the host,
    after a device synchronize."""
    import torch

    from eyoc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    preset = PRESETS[dataset]
    cap = preset["max_points"]
    cfg = sc2_config(dataset)

    N = len(loader) if num_pairs < 0 else min(num_pairs, len(loader))
    stats = []
    t_model = 0.0
    for i in range(N):
        x0, x1, f0, f1, gt = loader.get_data(i)
        t0 = time.perf_counter()
        padded = pad_pair(x0, x1, f0, f1, cap)
        trans, labels, nn = register_padded(
            *(torch.from_numpy(a).to(dev) for a in padded), cfg,
            use_icp=use_icp)
        trans, labels, nn = (a.cpu().numpy() for a in (trans, labels, nn))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_model += time.perf_counter() - t0
        if collect_poses is not None:
            collect_poses.append(trans)
        n0 = len(x0)
        labels = labels[:n0]
        nn = nn[:n0]

        # correspondence set (reference test_KITTI.py:40-57): source
        # keypoints + their feature-matched targets
        src_corr = x0
        tgt_corr = x1[np.clip(nn, 0, len(x1) - 1)]
        # gt inlier labels under gt_trans (reference test_KITTI.py:48-51)
        warp = x0 @ gt[:3, :3].T + gt[:3, 3]
        gt_labels = (np.linalg.norm(warp - tgt_corr, axis=-1)
                     < preset["inlier_threshold"]).astype(np.float32)
        tm = transformation_metrics(
            trans, gt, src_corr, tgt_corr, labels,
            re_thre=preset["re_thre"], te_thre=preset["te_thre"])
        tm.update(classification_metrics(labels, gt_labels))
        tm["inlier_ratio"] = float(gt_labels.mean())
        stats.append(tm)
        if i % log_every == 0:
            rr = np.mean([s["recall"] for s in stats])
            logging.info(f"{i}/{N} RR {rr:.2f}")

    # reference reports RE/TE averaged over SUCCESSFUL pairs only
    # (test_KITTI.py:106-118)
    ok = [s for s in stats if s["recall"] > 0]
    return dict(
        rr=float(np.mean([s["recall"] for s in stats])),
        re_deg=float(np.mean([s["re_deg"] for s in ok])) if ok else float("nan"),
        te_cm=float(np.mean([s["te_cm"] for s in ok])) if ok else float("nan"),
        f1=float(np.mean([s["f1"] for s in stats])),
        precision=float(np.mean([s["inlier_precision"] for s in stats])),
        inlier_ratio=float(np.mean([s["inlier_ratio"] for s in stats])),
        model_time=t_model / max(1, N),
        n=N,
    )


def main(argv=None):
    """The JAX harness's flags and defaults, and --device (default: the
    card)."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--dataset", default="KITTI",
                   choices=sorted(PRESETS))
    p.add_argument("--descriptor", default="fcgf",
                   choices=["fcgf", "fpfh", "predator"])
    p.add_argument("--num_pairs", default=-1, type=int)
    p.add_argument("--scene_protocol", action="store_true",
                   help="3DMatch per-scene gt.log protocol "
                        "(reference test_3DMatch.py) instead of a flat "
                        "npz pair directory")
    p.add_argument("--lomatch_pkl", default="",
                   help="3DLoMatch.pkl index (reference test_3DLoMatch.py)")
    p.add_argument("--gt_benchmark_folder", default="",
                   help="per-scene gt.log+gt.info tree for the Redwood "
                        "trajectory benchmark (reference benchmark_predator)")
    p.add_argument("--use_icp", action="store_true",
                   help="ICP post-refinement of each estimated pose "
                        "(reference test_KITTI.py:127, benchmark_utils.py:"
                        "40-56)")
    p.add_argument("--seed", default=51, type=int,
                   help="determinism seed (reference set_seed(51), "
                        "benchmark_utils.py:27-37); keys the predator "
                        "importance subsampling per pair")
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA device; 'cpu' "
                        "runs the plain versions)")
    args = p.parse_args(argv)
    device = args.device
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(message)s")
    np.random.seed(args.seed)
    if args.scene_protocol:
        return eval_3dmatch(args.root, args.dataset, args.descriptor,
                            num_pairs=args.num_pairs,
                            gt_benchmark_folder=args.gt_benchmark_folder or None,
                            use_icp=args.use_icp, device=device)
    if args.lomatch_pkl:
        loader = ThreeDLoMatchPklLoader(args.root, args.lomatch_pkl,
                                        args.descriptor, seed=args.seed)
        poses: list = []
        res = eval_descriptor_pairs(loader, args.dataset, args.num_pairs,
                                    collect_poses=poses, use_icp=args.use_icp,
                                    device=device)
        if args.gt_benchmark_folder:
            from eyoc_tpu_torch.benchmarks.gtlog import benchmark_trajectories

            res["trajectory"] = benchmark_trajectories(
                np.asarray(poses), args.gt_benchmark_folder, log=logging.info)
    else:
        loader = NpzPairLoader(args.root, args.descriptor)
        res = eval_descriptor_pairs(loader, args.dataset, args.num_pairs,
                                    use_icp=args.use_icp, device=device)
    logging.info(
        f"RR {res['rr']:.2f}%  RE {res['re_deg']:.3f} deg  "
        f"TE {res['te_cm']:.2f} cm  model {res['model_time']*1e3:.1f} ms/pair "
        f"({res['n']} pairs)")
    return res


if __name__ == "__main__":
    main()
