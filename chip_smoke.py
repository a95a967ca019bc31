#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`eyoc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. card and build: the card's name and power limit from nvidia-smi; every
   CUDA kernel built from the sources in `eyoc_tpu_torch/csrc/`.
2. every kernel against its plain PyTorch version on the same CUDA tensors.
   First the sparse coordinate kernels at the eval shape (one cloud of
   131072 points) and the train shape (the 8 clouds of a batch side, the
   maps with their inverses): K10 `voxelize` (two launches around one
   torch.sort, the compaction one block a tile of 2048 sorted keys), K11
   `brick_pyramid` and K12 `conv_maps` (two launches each), every output
   bit-equal to the plain version and the same bits twice, with device
   kernels a call, host us a call and the bound (bytes; the sort's too);
   then the others at the main paths' shapes: error, kernel time and plain
   time (CUDA events over back-to-back calls), the kernel's device time
   over the same calls (torch.profiler), the least time the card could
   take (bound) and, where one PyTorch call computes the same function,
   that call's time (timed in turns with the kernel). K4 on two sets (the
   registration set, and a tie-heavy one where most keys are 0 and some
   seeds point at invalid rows): `sc2_seed_counts` bit-equal to its plain
   version, and `sc2_seed_topk`'s [S, k1] indices bit-equal, in order, to
   the plain selection (masked plain counts, then `topk`), beside the
   unfused path on the card (the counts kernel, the mask and the full-row
   sort) and the cuBLAS time of the bare fp16 [S, N] @ [N, N] product on
   prebuilt masks (product only, not the same function). K1 (the eval
   forward, on the calls of one ResUNetBN2C forward) and the training
   kernels (the train forward, the conv backward, the row gather, the
   masked-BN sums, K22 `masked_norm_apply` (the BN apply with its fused
   ReLU or residual tail: equal values, one device kernel a call) and K21
   `masked_norm_backward` (the BN backward through that tail, S = 1: dx
   within K21_ULPS bf16 ulps, dresidual bit-equal, dscale / dbias within
   K21_REL; one cooperative launch a call, the same bits twice), on the calls
   recorded during one full-width train step); K1's, K5's and K7's times
   (kernel and device) are also split by shape class, and K2's train row
   by class (the GT pairs, one batched call a step, and the mining). K1
   (eval), K2, K3, K4, K5 and K7 give the same bits on a second call; K3
   and every K2 call run exactly one device kernel, K4's top k three
   (profiler); the host cost of one K1, K2, K3, K4, K5, K6 and K7 launch
   is measured on its own (host clock over calls that are not waited for).
   The labeling kernels, on the calls recorded during one extension step
   at the published recipe and one at the demo's gates (phase 6's
   configurations): K2's matching (both directions of 8 pairs, [16, 16384,
   32], in one call) and rediscovery, K3 and K4 on the 8 SC2-PCR calls at
   N = 8000 and S = 1600, K8 (`masked_knn2`, the gated matching's top 2,
   on the tensor cores: its bound there and at the f32 rate both kept)
   and K9 (`masked_argmin_excl`, the safe-radius mining at 8192 x 2048,
   r = 1.5 m, on the tensor cores as K8: both bounds kept); each against its plain version, the same bits twice, its
   device kernels a call and its host cost. SC2-PCR's K13 `sc2_nms`, K14
   `sc2_seed_transforms` and K15 `sc2_irls` at the eval shape (B = 1, N =
   5000, S = 1000: the kernels line's rows), on synthetic problems at the
   labeling shape (B = 8, N = 8000, S = 1600, 0-8000 valid rows) and on
   the 8 problems of one recorded labeling (the `_label` rows): K13's
   seeds bit-equal, in 2 device kernels a call (no sort); K14's consensus sets bit-equal; K14's poses, K15's
   one-round and final poses held to the same solve in f64 (K14: QCP on
   the plain version's consensus points and weights; K15: the IRLS rounds)
   within 1 mm plus C times the f32 rounding reach 2^-24 * lever * E / gap
   of each weighted set (K14 also the consensus weights' rounding; K14 and
   K15 also the f32 QCP solve's own, `_qcp_reach`: the root's, carried
   into the adjugate column, the adjugate's and the polish steps', each
   moved alone and the solve's tail run again in f64; the ratios to the
   reach without it logged), C twice the plain version's own largest ratio in
   the same run (K14's and K15's each their own), on every seed or problem
   whose set pins a pose (the others counted and logged); the fitness, best seed and
   K15's rounds equal but for inlier tests within SC2_EPS of the
   threshold (f64), or moved across it by those poses; the same bits
   twice, device kernels a call, host cost (K14: 3, the compaction of the
   valid rows, the consensus of the seeds whose k1 columns differ from the
   seed before's, the fitness with the argmax; K15: 1, its rounds and
   device time a round logged); again on 2 problems of 9000 rows at
   clusters of 2 CTAs, past the cluster's shared-memory cap (the rows
   from the global copy); and
   `sc2_pcr_batched` with no host sync (sync debug mode "error"). The same
   checks for K23 `sc2_seed_transforms_jacobi` and K24 `sc2_irls_jacobi`
   (qcp_kabsch=False: the poses held to the port's 8-sweep Jacobi Kabsch
   run in f64) at the eval shape and on the labeling shape's synthetic
   problems (the `_label` rows), and for K15 and K24 at refine_unroll = 4
   (exactly 4 rounds, held round by round to the f64 run); K3's bf16 form
   (bf16_power) within K3_BF16_RTOL of max |v| of its plain version, and
   the f32 plain vector at least K3_BF16_SEP times as far from that
   version as the kernel is (the rounding shows), one device kernel a
   call. The Jacobi solve's branch-free forms (csrc/jacobi_pose.cuh,
   `check_jacobi_forms`): every float of [1, 2^128) through the root, of
   [1, 2^126] through the reciprocal and of [1, 2] through the reciprocal
   root, 2^28 random quotient pairs and every exponent boundary pair, each
   bit-equal to __fsqrt_rn / __fdiv_rn, and jacobi_pose bit-equal to
   jacobi_pose_ieee on 2^18 weighted sets, as many 3-point sets and the
   special Horn matrices; K16, K18's polish and icp_solve give their
   parent design's digests (`check_jacobi_digests`, JACOBI_DIGESTS), and
   the solves that took the IEEE rerun are logged for each phase.
   RANSAC's and ICP's kernels at the path's shapes (N = 5000 correspondences at 30% inliers, the default
   RansacConfig; ICP's 32768-point clouds of a scan): K16's two-stage
   entry `ransac_hypotheses_topk` (H = 1048576, a 512-row subset, the top
   2048; 6 device kernels a call) with its edge flags bit-equal to the
   plain version's, its coarse counts the same bits as K16's single-stage
   entry and its kept poses that entry's rows; on the first RANSAC_SLICE
   hypotheses, each single-stage pose held to the f64 Kabsch of its
   triplet (within RANSAC_DISP + RANSAC_ROT / gap * lever) where the Horn
   gap pins one (the others counted), each coarse count equal to the f64
   recount of that pose but for tests within RANSAC_EPS of the threshold,
   and to the plain version's but for tests that the two poses move across
   it; keep bit-equal to `topk` of the kernel's own coarse, and the kept
   poses held to the f64 Kabsch as those of the slice; the bound
   recounted from the survivors (the single-stage count logged beside it);
   K17 `ransac_verify` (over K16's 2048 kept poses, 5000 rows; 1 device
   kernel) with its counts within the same bands and the first argmax;
   K18 `ransac_polish` (5 rounds) and
   `icp_solve` (3 device kernels a call) within POLISH_TOL of the plain
   version and of the f64
   solve (SVD) over the valid rows, the polish's inlier count equal; K2
   at ICP's shape (32768 x 32768 x 3) against the f64 nearest neighbour
   and the plain version's where the gap is clear; each the same bits
   twice, with its device kernels a call, host cost, bound and plain time
   (no single library call computes any of them). The valid step's K19
   `est_quad_linear_robust` at its shape (B = 1, N = 5000 correspondences
   at 30% inliers) and on a batch of 3 problems of 9000 rows with 0, 3
   and 9000 valid rows (past its shared-memory row cap): every valid row
   within K19_TOL of the plain version's pose and of the same 20 rounds in
   f64, the identity where no row is valid, one device kernel a call; K20
   `masked_instance_norm` on the 14 calls of one full-width ResUNetIN2C
   forward, within K20_ULPS bf16 ulps of its plain version, two device
   kernels a call (the statistics, then the apply); each the same bits
   twice, with its host cost, bound and plain time (no library call: no
   PyTorch call gives a masked per-cloud norm).
3. the eval path at full width: ResUNetBN2C (random weights from a fixed
   generator) through the test protocol (`eval.test_pair`) on synthetic
   KITTI-scale pairs at d = 45 m; finite poses, unit-norm features, and
   every kernel of the path launched (launch counts reset just before, read
   just after): one `sc2_seed_topk` a pair and no `sc2_seed_counts`, one
   K10, K11 and K12 call a cloud, and no sort or top-k over S x N elements
   (nor K13's [1, N] one) in the profiler's view of a pair, and one K13,
   K14 and K15 call a pair. Before it, and before phases 5 and 6
   on their own batch sides (`coord_path_checks`): the device kernels of
   one `preprocess_clouds` call (K10's 2, the sort's, K11's 2) beside the
   plain version's on the same tensors, no host sync in it or in
   `conv_maps` (sync debug mode "error"; with the inverses too, whose
   collision count a forced collision shows raising at the first conv
   backward), and its peak memory under the plain version's dense grid.
   Then the
   same pairs with RANSAC, the test CLI's default estimator
   (`eval.test_pair` with `use_ransac`): finite poses, exactly one K2,
   K16 (two-stage), K17 and K18 `ransac_polish` launch a pair, no
   single-stage K16 and no SC2-PCR kernel, `register_pair` with no host
   sync (sync debug mode "error"), its peak device memory logged and below
   one [H, 4, 4] pose array, no sort over H elements in a profiled pair,
   the registration split by stage (subset, K2, K16 with the top 2048,
   K17, K18), and one pair with `downsample_single` 0.5. No K19 or K20 in
   the test protocol of a BN model. Then the valid step
   (`eval.valid_pair`) on the same pairs: finite metrics, one K2 and one
   K19 launch a pair; and `eval.valid_metrics` on a known answer (pair
   0's voxelized cloud 0 under a known pose, row for row, the same random
   features and subset uniforms on both sides): RTE < 0.05 m, RRE < 0.1
   deg, hit ratio >= 0.99, loss < 0.01.
4. registration sanity: `sc2_pcr_batched` on three known-pose problems
   of N = 5000 correspondences (30% and 10% inliers, and 30% with 500
   valid rows) recovers each pose, and each problem is the same bits as
   its own B = 1 call (`sc2_pcr`); RANSAC recovers the same three poses
   within the same tolerances. ICP (`icp_refine_numpy`: 5 cm voxels,
   32768 points, r 0.2 m, 100 rounds) on a KITTI-scale scan and the same
   scan under a known pose, from that pose perturbed by 0.1 m and 0.5
   deg, reaches RTE < 0.02 m and RRE < 0.1 deg with 101 K2 and 100
   `icp_solve` launches and no host sync, and the plain path ends within
   ICP_TOL of it. Then the three problems again under each of
   SC2_OPTIONS (qcp_kabsch=False; refine_unroll = 4 with each solve;
   bf16_power; approx_topk): each pose recovered within the same
   tolerances, each problem the same bits as its B = 1 call, and the
   kernels each run launched (K23 / K24, K15 / K24 unrolled, K3's bf16
   form; counts reset just before, read just after: the kernels line's
   rows of these switches take them); and the labeling shape's synthetic
   problems under qcp_kabsch=False, finite.
5. the training path at full width: `training.steps.base_train_step`
   (ResUNetBN2C, hardest-contrastive loss, SGD) on the published recipe's
   batch of 8 synthetic train-phase pairs at d = 8 m; one warm-up step,
   then 3 timed steps, each split by stage; a finite loss, positives found,
   finite and non-zero grads, parameters and BN statistics that moved, and
   every kernel of the step launched (counts reset just before, read just
   after), one K10, K11 and K12 call a side a step, one K7, K22 and K21 a
   BN norm a side a step (21 norms). Then where a step's time goes: the
   conv maps' share and a torch.profiler view of one more step.
6. the EYOC extension step at full width (`training.steps.
   extension_train_step`) at the published KITTI recipe
   (scripts/train_kitti_EYOC.sh: feature filter "None", Similarity over
   the waymo tables at 0.6, SC2-PCR with 8000 points and 1600 seeds,
   5000 matches a direction, 2 m rediscovery) on phase 5's batch, a fresh
   student and its labeler (a copy): one warm-up step, then 3 timed
   steps, each split by stage and followed by the EMA labeler sync (decay
   0.2); finite metrics, the labeler's BN buffers unchanged by its
   forwards, its parameters the EMA formula bit for bit after each sync,
   and the launches of each step (8 K3, 8 K4, one K13, K14 and K15 for
   the 8 problems, one K2 for the matching of all 16 problems, one for
   the rediscovery, two for the mining, two K10 and K11, four K12: the
   labeler's two forwards and the student's); a torch.profiler view of
   one more step. Then one step at the extension
   demo's gates (Lowe, Spherical at 40 m, safe-radius mining at 1.5 m,
   translation floor 0.4): one K8 and two K9 launches. Then `label_pairs`
   on a known answer at full size (cloud 1 is cloud 0 under a known pose,
   row for row, the same random features on both sides), feature filters
   "None" and "Lowe": RTE < 0.05 m, RRE < 0.1 deg, hit ratio >= 0.99, and
   >= 99% of the rediscovered rows map to themselves.
7. the instance-norm family at full width: ResUNetIN2C and SimpleNetIN2
   (random weights) through `eval.test_pair` (SC2-PCR) and
   `eval.valid_pair` on pair 0: unit-norm features, finite poses and
   metrics, and one forward's K20 launches equal to the model's instance
   norms (14 and 8).
8. training the instance-norm family at full width (phase 5's recipe and
   batch): ResUNetIN2C (7 BN top-level norms, 14 IN block norms), a
   warm-up step, then one step whose K20 calls (the train forward's, with
   each cloud's statistics: y in K20_ULPS, a residual call's y within an
   ulp of y0 plus one of y, the statistics within K20_STATS_REL), K22 and
   K21 calls (both norms) are held to their plain versions, the same bits
   twice; then TRAIN_STEPS steps, each with its draws made beforehand and
   run under sync debug mode "error": a finite loss, finite grads, every
   parameter with a grad moved, and each step's launches (K20 and K21 for
   each IN norm of each side, K7, K22 and K21 for each BN norm), and a
   torch.profiler view of one more; one `extension_train_step` at phase
   6's labeling (a fresh student and its labeler: K20 and K22 also for
   the labeler's two forwards, its BN buffers unchanged); SimpleNetIN2 (8
   IN norms, its pre-ReLU skips), one base step the same way.
9. the trainer: `cli.train.main` in-process with ContinuousCorrExtension-
   Trainer over SyntheticContinuousPairDataset at the KITTI launcher's
   flags, phase 5's width and batch, caps (16384, 5120, 1600, 500) (the
   extension demo's level shrink 3.2; phase 5's are CAPS):
   a base epoch, two extension epochs (the labeler's first sync, then an
   EMA sync), a validation of 2 pairs and a checkpoint after each, the
   best one kept; every kernel of the path launched (counts reset just
   before `main`, read just after); the trainer's Data and Iter times a
   step and the validations' feat_match_ratio printed. A second `main`
   from `--resume_dir` starts at the next epoch with the student, the
   labeler, the optimizer state, num_updates and the generator equal to
   the saved ones. Then one base step each at iter_size 2, with Adam,
   with AdamW and with the contrastive, triplet and hardest-triplet
   losses, their K2 and K6 calls held to the plain versions.
10. the real-data runbook (README.md) through the port: a
   reference-style best_val_checkpoint.pth of ResUNetBN2C/32 (conv1 k = 5,
   random weights from a fixed generator, the port's exporter) imported by
   `tools.import_torch_ckpt.main(... --write_test_config)`; a KITTI-format
   tree of one test-split drive (12 synthetic raycast scans of <= 131072
   points, float32 xyzr .bin, calib.txt, poses.txt) in a temporary
   directory; `cli.test.main` over it on KITTINMPairDataset (the ICP ground
   truth on the card) with RANSAC, then with SC2-PCR, 4 pairs each: its
   kernels launched, rr / rte / rre / pairs_per_sec and the Data / Feat /
   Reg times printed, each pose the bits of `eval.test_pair` on the same
   batch and draws, RR the mean of `registration_success` on them.

11. feature widths other than 3 and 32: K2, K8 and K9 at D = 16, 33, 64
   and 200 (padded with zero columns to their instances, 32, 64 and 256)
   against their plain versions at the real width, at their tolerances,
   one launch a call; D = 16 padded by the wrapper and by hand the same
   bits; K1 at 20 output channels (padded to 24) in the eval form and
   through autograd against its plain version; a `width rows:` line with
   their times.
12. the rest of the model zoo, the whole extract_features and data
   parallelism, at full width:
   - ResUNetExpBN2C (two (norm, block) repeats a level; random weights,
     running statistics moved off (0, 1)): its 14 K22 calls of one eval
     forward (the 7 repeat norms a cloud, from the running statistics)
     against the plain version (equal values, one device kernel a call,
     the same bits twice); phase 3's 4 pairs through embed_pair and
     register_pair (counts reset just before: 7 K22 a cloud, no K7), then
     one train step at phase 5's recipe (K7, K22 and K21 once for each of
     its 42 batch norms a side), with the features' ms a pair and the
     step's ms beside the sum of their kernels' bounds;
   - api.extract_features on pair 0's cloud 0 with rgb (Ci = 3) and with
     rgb and normals (Ci = 6): the first conv on K1's narrow-input route
     (taps packed into K = 375, 750) against its plain version;
   - normalize_feature=False: one eval pair (the SC2-PCR estimator's K2
     on the raw features), one train step (K2's mining) and one extension
     step at the demo's gates (K8 on the labeler's raw features), K2 and
     K8 held to their plain versions with the index gap scaled to the
     features' own squared norm (K2_GAP at unit features);
   - data parallelism over NCCL at world size 1 (tcp://127.0.0.1): the DP
     train step (parallel/ddp.dp_train_step) gives the plain step's loss
     and every parameter and statistic bit for bit (K6's backward, which
     adds with float atomics, replayed from the plain step); with the
     collectives forced at one rank (sparse/norm.sync_group keeping its
     group), the K7 sums all_reduce'd and K21 in its two-launch form (sums
     pass, all_reduce, finish pass) give those bits too, and each recorded
     two-launch call the one-launch form's bits and the plain version's
     values; the DP and plain steps' times in turns.
13. the tail (`tail_phase`):
   - the descriptor harness (benchmarks.descriptor_eval.main) at the
     presets' size, every cloud 8000 keypoints of GT-consistent
     descriptors with 30% corrupted rows: the KITTI preset over 4 FCGF-32
     pairs without and with --use_icp, the 3DMatch preset's scene
     protocol over 2 scenes of 3 FPFH-33 fragments (K2 on 64-wide
     zero-padded columns) with --gt_benchmark_folder, and the 3DLoMatch
     preset over a pickle index of 2 pairs; each run's kernels launched,
     each pose the bits of sc2_pcr_estimator (and ICP) on the same padded
     tensors and within phase 4's tolerances of its known pose, RR 100,
     model_time printed; a pair of 8001 keypoints raising ValueError
     before any launch; K2, K3, K4, K13-K15, icp_solve and ICP's K2 on
     one pair's calls (B = 1, N = 8000, S = 1600, every row valid)
     against their plain versions, the `_desc` rows;
   - tools.record_similarity.main over phase 10's tree and imported
     checkpoint (4 pairs, KITTINMPairDataset): K10-K12, K1, K2 and four K6
     gathers a pair launched, the triples under `valid` the plain
     gathers' (d0 / d1 bit-equal, cos within 1e-6), the tables read back
     by load_similarity_tables and driving spatial_filter_mask as a host
     lookup of the same cells; the step's ms a pair;
   - the 3DMatch configuration: a synthetic 3DMatch tree (rooms 3.5-5 m
     across, fragments of 100000 points filling ~26000 voxels at 2.5 cm),
     cli.train.main with ThreeDMatchPairDataset at voxel 0.025 m and the
     repo's defaults (ResUNetBN2C / 32, HardestContrastiveLossTrainer,
     B = 4, rotation 360; window bits 9,9,9), each level's fill against
     the host's distinct cells (no overflow), every kernel of the train
     and valid steps launched, the loss finite; cli.test.main over the
     test split (4 pairs, SC2-PCR, window bits 9,9,8): no point dropped,
     each pose the bits of eval.test_pair; one step's device time.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi line; before that, a {"kernels": [...]} line with the numbers of
each kernel on each path (K1 and K2 run on both: their training rows are
`sparse_conv_train` and `masked_argmin_train`; K2, K3, K4 and K13-K15 on
the labeling path are `*_label`; K2 in ICP is `masked_argmin_icp`; K19's
launches are the valid run's, K20's phase 7's; K20's train forward is
`masked_instance_norm_train` and K21's rows are `masked_norm_backward`
(instance norm, phase 8) and `masked_norm_backward_bn` (phase 5); phase
9's loss steps give `masked_argmin_triplet` (the hardest triplet's K2
calls) and `take_rows_losses` / `take_rows_backward_losses` (K6 in the
three other losses); phase 4's runs give the rows of SC2PCRConfig's
switches: `sc2_power_iteration_bf16`, `sc2_seed_transforms_jacobi` and
`sc2_irls_jacobi` (K23, K24; with `_label` the labeling shape's),
`sc2_irls_unroll` and `sc2_irls_jacobi_unroll`); phase 12 gives
`masked_norm_apply_eval` (K22 at eval in ResUNetExpBN2C),
`sparse_conv_ci3` / `sparse_conv_ci6` (K1's packed route in
extract_features; launches: the run's K1 launches), `masked_argmin_raw` /
`masked_knn2_raw` (K2 and K8 on features that are not unit-norm) and
`masked_norm_backward_sync` (K21's two-launch form); phase 13 gives the
`_desc` rows (the descriptor harness's K2, K3, K4, K13-K15, `icp_solve`
and ICP's K2 at B = 1, N = 8000, S = 1600; launches: the KITTI runs'); `ms`
is CUDA-event time,
`device_ms` the profiler's device time of the same calls, so a row whose
`ms` is well above its `device_ms` is bound by the host's launch path. It
needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

RAW = 131072
CAPS = (16384, 5120, 1536, 512)
WINDOW_BITS = (9, 9, 7)
N_PAIRS = 4
PAIR_DIST = 45.0
N_CORR = 5000
N_SEEDS = 1000
# the published training recipe (scripts/train_kitti_EYOC.sh): batch 8,
# num_pos 1024 * B, num_hn_samples 256 * B, SGD momentum 0.8; the learning
# rate is the package default 0.1 (eyoc_tpu/config.py:131), not the
# script's 0.3 (timing does not depend on it)
TRAIN_B = 8
TRAIN_DIST = 8.0
TRAIN_STEPS = 3
PROBE_ROWS, PROBE_COLS = 20480, 256   # proto/proto_pallas_gather.py:24
# the EYOC extension step (phase 6): SC2-PCR's labeling size at the KITTI
# config, the steps timed after a warm-up, the labeler's EMA decay, and the
# extension demo's gates (experiments/extension_demo.py) with the
# Spherical filter of the nuScenes and Waymo launchers
LABEL_N, LABEL_S = 8000, 1600
REDISCOVERY = 5000        # StepConfig.rediscovery_samples
EXT_STEPS = 3
EXT_DECAY = 0.2
GATED = dict(feature_filter="Lowe", spatial_filter="Spherical",
             filter_radius=40.0, hn_safe_radius=1.5,
             label_min_translation_frac=0.4)

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s.
# b1 (AND + POPC, 2 ops a binary product) has no published rate: it is 8x
# the int8 peak, as profile_k4_mma.py measures wgmma b1 m64n256k256 at
# 8.0x wgmma s8 m64n256k32 (15.59-15.72 and 1.94-1.96 P ops/s on an H100
# 80GB HBM3 at 700 W; the s8 rate is 98-99% of the int8 peak)
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "tf32": 495e12}
PEAK["b1"] = 8 * PEAK["int8"]

# tolerances of kernel against plain version
K1_RTOL, K1_ATOL_FRAC = 2e-2, 1e-2   # bf16 output, f32 sums in two orders
K2_D2_RTOL = 1e-4                    # direct vs Gram-form squared distance
K2_GAP = 1e-3                        # indices equal where 2nd - 1st > gap
K3_RTOL, K3_ATOL = 1e-4, 1e-7        # f32 power iteration, summation order
# K3's bf16 form against its plain version, within K3_BF16_RTOL of max |v|
# at the eval shape (the kernel reads ~1e-5 of it on an H100: its SC and
# iterate differ from the plain version's by their f32 sum orders, and a
# value across a bf16 rounding boundary moves by 2^-8 of itself); the f32
# plain vector, ~2e-4 of max |v| away there, must lie K3_BF16_SEP times
# as far from the bf16 plain vector as the kernel does, or nothing shows
# that the kernel rounds
K3_BF16_RTOL = 3e-5
K3_BF16_SEP = 4.0
K3_F64_FACTOR = 2.0                  # ill-conditioned input: vs f64 plain
K5_RTOL, K5_ATOL_FRAC = 1e-3, 1e-3   # f32 dW, f32 sums of bf16 products
K6B_RTOL, K6B_ATOL = 1e-5, 1e-6      # f32 atomics vs index_add_ order
K7_REL = 1e-4                        # of the sums of absolute values
SMALL_REPS = 200                     # repetitions of the us-sized kernels
LIBRARY_ROUNDS = 6                   # kernel / library timing rounds


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _dev_ms(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0)) / 1e3


def device_ms(thunks, reps: int):
    """Device time (torch.profiler) of one pass over `thunks`, from `reps`
    passes: the kernels' own time, without the host's share, as each
    kernel's (and copy's) mean record times its records a pass. The
    profiler drops a device record now and then (all of them for a short
    window after long ones): the records a pass are ceil(records / reps),
    and a window whose kernels a pass, times `reps`, come short of the
    runtime's kernel launches on the host (cudaLaunch*, as `count_kernels`
    counts them) is taken again, up to three times; None if every window
    came short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for f in thunks:
        f()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in thunks:
                    f()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        device = [e for e in averages if e.device_type.name == "CUDA"
                  and e.count > 0]
        kernels = [e for e in device
                   if not e.key.startswith(("Memcpy", "Memset"))]
        n = sum(e.count for e in kernels)
        a_pass = sum(-(-e.count // reps) for e in kernels)
        launched = sum(e.count for e in averages
                       if e.key.startswith(("cudaLaunch", "cuLaunch")))
        if n > 0 and a_pass * reps >= launched:
            if n < launched:
                log(f"  device time: {n} records of {launched} kernel "
                    f"launches; each kernel's mean record times its "
                    f"{reps}-pass count rounded up")
            return sum(_dev_ms(e) / e.count * -(-e.count // reps)
                       for e in device)
        log(f"  device time: window {attempt + 1} of 3 recorded {n} of "
            f"{launched} kernel launches; taken again")
    return None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.3f} ms"


def host_us(thunks, reps: int) -> float:
    """Host microseconds per call of `thunks`: the host clock over `reps`
    passes that are not waited for (the launch path alone, while the
    device runs behind)."""
    import torch
    for f in thunks:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in thunks:
            f()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / (reps * len(thunks)) * 1e6


def op_ms(ops, kind) -> float:
    """ms for `ops` at PEAK[kind]; `ops` may be {kind: ops} for work split
    over units that issue at once (K8: the tensor cores' products and the
    CUDA cores' epilogue, interleaved by the block's warps), whose floor is
    the slowest unit's time."""
    if isinstance(ops, dict):
        return max(v / PEAK[k] for k, v in ops.items()) * 1e3
    return ops / PEAK[kind] * 1e3


def bound_ms(nbytes: float, ops, kind: str | None):
    tb, to = nbytes / HBM_BPS * 1e3, op_ms(ops, kind)
    return max(tb, to), ("bytes" if tb >= to else "operations")


def make_pairs():
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
    ds = SyntheticPairs(n_pairs=N_PAIRS, n_points=RAW, dist=PAIR_DIST,
                        phase="test", voxel_size=0.3)
    return [collate_items([ds[i]], RAW) for i in range(N_PAIRS)]


# ------------------------------------------------------------------ phase 2


def check_sparse_conv(model, pyr):
    """Every sparse_conv call of one ResUNetBN2C eval forward, kernel vs
    plain; then the host cost of a K1 call over those calls."""
    import torch
    from eyoc_tpu_torch.models import unet
    from eyoc_tpu_torch.sparse.brick_conv import sparse_conv_plain

    calls = []
    real = unet.sparse_conv

    def record(x, W, nmap, **kw):
        calls.append(((x, W, nmap), kw))
        return real(x, W, nmap, **kw)

    unet.sparse_conv = record
    try:
        model.embed(pyr)
    finally:
        unet.sparse_conv = real
    torch.cuda.synchronize()
    out = check_calls("K1 sparse_conv, one eval forward", calls, real,
                      sparse_conv_plain, _conv_cost,
                      _bf16_close(K1_RTOL, K1_ATOL_FRAC),
                      classify=_conv_class)
    # the tap split adds its partials in a fixed order: the same bits twice
    same_bits_twice("K1 sparse_conv", real, calls)
    launch_path("K1 sparse_conv", real, calls, "one eval forward", 10)
    return out


def same_bits_twice(label, fn, calls):
    """Every recorded call gives the same bits on a second call: the
    kernel's sums run in a fixed order."""
    import torch

    def same(x, y):
        if isinstance(x, (tuple, list)):
            return all(same(u, w) for u, w in zip(x, y))
        if x is None or y is None:
            return x is None and y is None
        return torch.equal(x, y)
    with torch.no_grad():
        for a, k in calls:
            if not same(fn(*a, **k), fn(*a, **k)):
                shapes = [tuple(t.shape) for t in a if hasattr(t, "shape")]
                raise AssertionError(f"{label} {shapes} gives other bits on "
                                     "a second call")
    log(f"{label}: each of the {len(calls)} calls gives the same bits twice")


def launch_path(label, fn, calls, what, reps):
    """The host's cost of one call: the host clock over `reps` passes of
    the recorded calls, not waited for."""
    import torch
    with torch.no_grad():
        us = host_us([lambda a=a, k=k: fn(*a, **k) for a, k in calls], reps)
    log(f"{label} launch path: {us:.2f} us of host time per call (the "
        f"{len(calls)} calls of {what}, {reps} passes)")


def count_kernels(fn, reps: int = 5):
    """(device kernels one call of `fn` runs, the profiler's kernel events):
    torch.profiler over `reps` calls, memory copies and fills not counted.
    The profiler also records the runtime's kernel launches on the host
    (cudaLaunch*): where its device records come short of them (a window
    after many earlier profiles can miss one ms-long cooperative kernel),
    the launches are the count. A profile that recorded no device activity
    at all is taken again, up to five times; if none of them recorded any
    but they recorded the launches (the profiler's device tracing can stay
    silent for several windows in a row), the launches of the last are the
    count. With neither it fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type.name == "CUDA"
                  and not e.key.startswith(("Memcpy", "Memset"))]
        n = sum(e.count for e in events)
        launched = sum(e.count for e in averages
                       if e.key.startswith(("cudaLaunch", "cuLaunch")))
        if n > 0:
            return max(n, launched) / reps, events, n, launched
    if launched > 0:
        log(f"  the profiler recorded no device kernel in 5 windows; "
            f"counting its {launched} launch records over {reps} calls")
        return launched / reps, events, n, launched
    raise AssertionError("the profiler recorded no device kernel and no "
                         "launch")


def kernels_per_call(label, fn, reps: int = 5, expected: float = 1) -> float:
    """Device kernels that one call of `fn` runs (`count_kernels`); the K3
    and K2 wrappers must run exactly one, K4's top k three."""
    k, events, n, launched = count_kernels(fn, reps)
    log(f"{label}: {k:g} device kernels a call (profiler, {reps} calls: "
        f"{n} device records, {launched} launches; device ms a call: "
        + ", ".join(f"{e.key[:60]} {_dev_ms(e) / reps:.4f}" for e in events)
        + ")")
    if k != expected:
        raise AssertionError(f"{label}: {k:g} device kernels a call, "
                             f"expected {expected:g}")
    return k


def check_masked_argmin(gen):
    """D = 32 (feature matching, timed) and D = 3 (coordinates, f32)."""
    import torch
    from eyoc_tpu_torch.ops.knn import masked_argmin, masked_argmin_plain

    worst = 0.0
    for D in (3, 32):
        q = torch.randn(N_CORR, D, generator=gen)
        r = torch.randn(N_CORR, D, generator=gen)
        if D == 32:
            q = torch.nn.functional.normalize(q, dim=1)
            r = torch.nn.functional.normalize(r, dim=1)
        q, r = q.cuda(), r.cuda()
        qm = (torch.rand(N_CORR, generator=gen) < 0.95).cuda()
        rm = (torch.rand(N_CORR, generator=gen) < 0.95).cuda()
        d_k, i_k = masked_argmin(q, qm, r, rm)
        d_p, i_p = masked_argmin_plain(q, qm, r, rm)
        # the gap between the first and second nearest valid ref, per query
        full = torch.cdist(q, r) ** 2 + torch.where(rm, 0.0, 1e30)[None]
        two = torch.topk(full, 2, largest=False).values
        clear = qm & ((two[:, 1] - two[:, 0]) > K2_GAP)
        if not bool(torch.equal(i_k[clear], i_p[clear])):
            raise AssertionError(f"masked_argmin D={D}: indices disagree "
                                 "on clear gaps")
        err = float((d_k - d_p).abs().max())
        if not bool(torch.allclose(d_k, d_p, rtol=K2_D2_RTOL,
                                   atol=K2_D2_RTOL)):
            raise AssertionError(f"masked_argmin D={D}: distances "
                                 f"disagree: {err}")
        worst = max(worst, err)
        log(f"K2 masked_argmin: {N_CORR}x{N_CORR}x{D}, {int(clear.sum())} "
            f"clear queries equal, max d2 err {err:.3e}")
    # the last block of a query tile adds the splits in split order
    same_bits_twice("K2 masked_argmin (eval)", masked_argmin,
                    [((q, qm, r, rm), {})])
    launch_path("K2 masked_argmin (eval)", masked_argmin,
                [((q, qm, r, rm), {})], f"{N_CORR}x{N_CORR}x{D}", 200)
    kernels_per_call("K2 masked_argmin (eval)",
                     lambda: masked_argmin(q, qm, r, rm))
    ms = time_ms(lambda: masked_argmin(q, qm, r, rm))
    plain = time_ms(lambda: masked_argmin_plain(q, qm, r, rm), reps=3)
    nq, nr = int(qm.sum()), int(rm.sum())
    b, by = bound_ms(2 * N_CORR * D * 4 + 2 * N_CORR + N_CORR * 8,
                     2.0 * nq * nr * D, "f32")
    dev = device_ms([lambda: masked_argmin(q, qm, r, rm)], 10)
    log(f"K2 masked_argmin at D={D}: kernel {ms:.3f} ms (device "
        f"{fmt_ms(dev)}), plain {plain:.3f} ms, bound {b:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


def correspondences(gen, n=N_CORR, inlier=0.3, noise=0.01):
    """Known pose + n correspondences, `inlier` of them true."""
    import torch
    from eyoc_tpu_torch.geometry.se3 import integrate_trans, transform_points
    src = torch.rand(n, 3, generator=gen) * torch.tensor([80.0, 80.0, 6.0]) \
        - torch.tensor([40.0, 40.0, 3.0])
    yaw = 0.25
    R = torch.tensor([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    T = integrate_trans(R, torch.tensor([3.0, -1.5, 0.2]))
    tgt = transform_points(src, T) + noise * torch.randn(n, 3, generator=gen)
    out = torch.rand(n, generator=gen) >= inlier
    tgt[out] = torch.rand(int(out.sum()), 3, generator=gen) * 80.0 - 40.0
    valid = torch.ones(n, dtype=torch.bool)
    return src.cuda(), tgt.cuda(), valid.cuda(), T.cuda()


def check_power_iteration(gen):
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import (
        sc2_power_iteration, sc2_power_iteration_plain)
    src, tgt, valid, _ = correspondences(gen)
    valid[-50:] = False
    k = sc2_power_iteration(src, tgt, valid, 0.1, 20)
    p = sc2_power_iteration_plain(src, tgt, valid, 0.1, 20)
    err = float((k - p).abs().max())
    if not bool(torch.allclose(k, p, rtol=K3_RTOL, atol=K3_ATOL)):
        raise AssertionError(f"sc2_power_iteration disagrees: {err}")
    call = [((src, tgt, valid, 0.1, 20), {})]
    # the partials are added in a fixed order: the same bits twice
    same_bits_twice("K3 sc2_power_iteration", sc2_power_iteration, call)
    launch_path("K3 sc2_power_iteration", sc2_power_iteration, call,
                f"N={N_CORR}", 200)
    kernels_per_call("K3 sc2_power_iteration",
                     lambda: sc2_power_iteration(src, tgt, valid, 0.1, 20))
    ms = time_ms(lambda: sc2_power_iteration(src, tgt, valid, 0.1, 20))
    plain = time_ms(lambda: sc2_power_iteration_plain(src, tgt, valid, 0.1,
                                                      20), reps=3)
    nv = int(valid.sum())
    # SC is symmetric: the least work is each unordered valid pair (and
    # the diagonal) once per iteration, ~24 flops each
    nbytes = 2 * N_CORR * 12 + N_CORR + N_CORR * 4
    b, by = bound_ms(nbytes, 20.0 * nv * (nv + 1) / 2 * 24, "f32")
    full = bound_ms(nbytes, 20.0 * nv * nv * 24, "f32")[0]
    dev = device_ms([lambda: sc2_power_iteration(src, tgt, valid, 0.1, 20)],
                    10)
    log(f"K3 sc2_power_iteration: N={N_CORR}, max err {err:.3e}, kernel "
        f"{ms:.3f} ms (device {fmt_ms(dev)}), plain {plain:.3f} ms, bound "
        f"{b:.4f} ms (half of SC; the full matrix {full:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


def _bf16_power_close(got, want, src, tgt, valid, d_thre, iters):
    """K3's bf16 form within K3_BF16_RTOL of max |v| of its plain version,
    and the f32 plain vector at least K3_BF16_SEP times as far from it."""
    from eyoc_tpu_torch.registration.sc2pcr import sc2_power_iteration_plain
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    f32 = float((sc2_power_iteration_plain(src, tgt, valid, d_thre, iters)
                 - want).abs().max())
    log(f"  K3 bf16: kernel {err:.3e} ({err / top:.3e} of max |v| "
        f"{top:.4e}; held to {K3_BF16_RTOL}) from the bf16 plain vector, "
        f"the f32 plain vector {f32:.3e} ({f32 / top:.3e}; held to at least "
        f"{K3_BF16_SEP} times the kernel's)")
    return err <= K3_BF16_RTOL * top and f32 >= K3_BF16_SEP * err, err


def check_power_iteration_bf16(gen):
    """K3's bf16 form (SC2PCRConfig.bf16_power) at the eval shape against
    its plain version (SC and each iterate rounded to bf16, f32 sums)
    within K3_BF16_RTOL of max |v|, the f32 plain vector K3_BF16_SEP times
    as far (`_bf16_power_close`): the same bits twice, one device kernel a
    call, its host cost, and K3's bound (the same pairs and operations,
    the two roundings aside)."""
    from eyoc_tpu_torch.registration.sc2pcr import (
        sc2_power_iteration, sc2_power_iteration_plain)
    src, tgt, valid, _ = correspondences(gen)
    valid[-50:] = False

    def fn(s, t, v, d, i):
        return sc2_power_iteration(s, t, v, d, i, bf16=True)

    def plain(s, t, v, d, i):
        return sc2_power_iteration_plain(s, t, v, d, i, bf16=True)
    call = [((src, tgt, valid, 0.1, 20), {})]
    tag = f"K3 sc2_power_iteration, bf16 (N = {N_CORR})"
    row = check_calls(tag, call, fn, plain, _power_cost, _bf16_power_close,
                      reps=10)
    same_bits_twice(tag, fn, call)
    launch_path(tag, fn, call, f"N={N_CORR}", 200)
    kernels_per_call(tag, lambda: fn(src, tgt, valid, 0.1, 20))
    return row


def seed_sets(gen):
    """K4's two input sets at the main path's shapes: the registration set
    (30% inliers) with its last 50 points invalid, and a tie-heavy set (no
    inliers: most keys are 0) with its last 500 points invalid, so that
    about one seed in ten points at an invalid row (all its keys 0 or -1)."""
    import torch
    out = []
    for inlier, n_bad in ((0.3, 50), (0.0, 500)):
        src, tgt, valid, _ = correspondences(gen, inlier=inlier)
        valid[-n_bad:] = False
        seeds = torch.randperm(N_CORR, generator=gen)[:N_SEEDS].to(
            torch.int32).cuda()
        out.append((src, tgt, valid, seeds))
    return out


def _k4_bound(valid, out_bytes, kind="b1"):
    """K4's bound: its S x nv x nv binary products at the b1 rate the
    kernel's MMAs run at (`kind="int8"`: at the int8 peak, the figure
    K4's bound used before it ran on b1 tensor cores)."""
    nv = int(valid.sum())
    return bound_ms(2 * N_CORR * 12 + N_CORR + N_SEEDS * 4 + out_bytes,
                    2.0 * N_SEEDS * nv * nv, kind)


def check_seed_counts(sets):
    """The counts entry (off the main path): bit-equal to the plain
    version on both sets."""
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import (
        sc2_seed_counts, sc2_seed_counts_plain)
    for src, tgt, valid, seeds in sets:
        k = sc2_seed_counts(src, tgt, valid, seeds, 0.1)
        p = sc2_seed_counts_plain(src, tgt, valid, seeds, 0.1)
        err = float((k - p).abs().max())
        if not bool(torch.equal(k, p)):
            raise AssertionError(f"sc2_seed_counts not exact: {err}")
    src, tgt, valid, seeds = sets[0]
    ms = time_ms(lambda: sc2_seed_counts(src, tgt, valid, seeds, 0.1))
    plain = time_ms(lambda: sc2_seed_counts_plain(src, tgt, valid, seeds,
                                                  0.1), reps=3)
    b, by = _k4_bound(valid, N_SEEDS * N_CORR * 4)
    b8 = _k4_bound(valid, N_SEEDS * N_CORR * 4, "int8")[0]
    dev = device_ms([lambda: sc2_seed_counts(src, tgt, valid, seeds, 0.1)],
                    10)
    log(f"K4 sc2_seed_counts: S={N_SEEDS} N={N_CORR}, exact on both sets, "
        f"kernel {ms:.3f} ms (device {fmt_ms(dev)}), plain {plain:.3f} ms, "
        f"bound {b:.4f} ms ({by}, products at the b1 rate; {b8:.4f} ms "
        "with the int8 peak)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


def check_seed_topk(sets, k1):
    """The main path's K4 entry: indices bit-equal, in order, to the plain
    selection (the masked plain counts, then `topk`) on both sets; then
    its times beside the unfused path on the card (the counts kernel, the
    mask and the full-row sort) and the cuBLAS time of the bare fp16
    product on prebuilt masks (product only, not the same function)."""
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import (
        _cross, sc2_seed_counts, sc2_seed_topk, sc2_seed_topk_plain, topk)
    wrong = 0   # indices that differ from the plain selection, both sets
    for name, (src, tgt, valid, seeds) in zip(("registration", "tie-heavy"),
                                              sets):
        got = sc2_seed_topk(src, tgt, valid, seeds, 0.1, k1)
        want = sc2_seed_topk_plain(src, tgt, valid, seeds, 0.1, k1)
        if got.shape != (N_SEEDS, k1):
            raise AssertionError(f"sc2_seed_topk ({name} set): shape "
                                 f"{tuple(got.shape)}")
        wrong += int((got != want).sum())
        if not bool(torch.equal(got, want)):
            bad = int((got != want).any(1).sum())
            raise AssertionError(f"sc2_seed_topk ({name} set): {bad} seed "
                                 "rows differ from the plain selection")
        log(f"K4 sc2_seed_topk ({name} set): [{N_SEEDS}, {k1}] indices "
            "bit-equal to the plain selection, first column "
            f"included; {int((~valid[seeds.long()]).sum())} seeds at "
            "invalid rows")
    src, tgt, valid, seeds = sets[0]

    def call():
        return sc2_seed_topk(src, tgt, valid, seeds, 0.1, k1)

    def unfused_path():
        sc2 = sc2_seed_counts(src, tgt, valid, seeds, 0.1)
        sc2 = torch.where(valid[None, :], sc2, torch.full_like(sc2, -1.0))
        return topk(sc2, k1)[1]

    keys = sc2_seed_counts(src, tgt, valid, seeds, 0.1)
    keys = torch.where(valid[None, :], keys, torch.full_like(keys, -1.0))
    same_bits_twice("K4 sc2_seed_topk", sc2_seed_topk,
                    [((src, tgt, valid, seeds, 0.1, k1), {})])
    launch_path("K4 sc2_seed_topk", sc2_seed_topk,
                [((src, tgt, valid, seeds, 0.1, k1), {})],
                f"S={N_SEEDS} N={N_CORR}", 200)
    kernels_per_call("K4 sc2_seed_topk", call, expected=3)
    ms = time_ms(call)
    plain = time_ms(lambda: sc2_seed_topk_plain(src, tgt, valid, seeds, 0.1,
                                                k1), reps=3)
    unfused = time_ms(unfused_path)
    sort = time_ms(lambda: topk(keys, k1))
    dev = device_ms([call], 10)
    # cuBLAS: the bare [S, N] @ [N, N] fp16 product of the masks, built
    # beforehand (no packing, no hard factor, no selection)
    pair_ok = valid[:, None] & valid[None, :]
    tight = ((_cross(src, tgt) < 0.05) & pair_ok).half()
    rows = tight[seeds.long()].contiguous()
    cublas = time_ms(lambda: torch.matmul(rows, tight))
    del tight, rows
    b, by = _k4_bound(valid, N_SEEDS * k1 * 4)
    b8 = _k4_bound(valid, N_SEEDS * k1 * 4, "int8")[0]
    log(f"K4 sc2_seed_topk: S={N_SEEDS} N={N_CORR} k={k1}, kernel "
        f"{ms:.3f} ms (device {fmt_ms(dev)}), plain {plain:.3f} ms, bound "
        f"{b:.4f} ms ({by}, products at the b1 rate; {b8:.4f} ms with the "
        f"int8 peak); unfused on the "
        f"card (the counts kernel, mask, full-row sort) {unfused:.3f} ms, "
        f"of which the masked sort "
        f"{sort:.3f} ms; cuBLAS fp16 [S, N] @ [N, N] on prebuilt masks "
        f"{cublas:.3f} ms (product only, not the same function)")
    return dict(max_abs_err=float(wrong), ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


# -------------------------------------------------- phase 2, coordinates


def _differ(got, want) -> int:
    """Elements that differ between two trees of tensors (tuples, named
    tuples, None); a shape or structure mismatch counts as all of them."""
    import torch
    if got is None or want is None:
        return 0 if got is None and want is None else 1 << 62
    if not torch.is_tensor(got):
        if len(got) != len(want):
            return 1 << 62
        return sum(_differ(a, b) for a, b in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        return 1 << 62
    return int((got != want).sum())


def _nbytes(tree) -> int:
    import torch
    if tree is None:
        return 0
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(t) for t in tree)


def _coord_row(label, fn, plain, nbytes, expected_kernels, note, reps=10):
    """One coordinate kernel against its plain version on the card: every
    output bit-equal, the same bits on a second call, its device kernels a
    call, its time (CUDA events), device time (profiler), host cost a call
    and its bound (bytes at HBM_BPS)."""
    got = fn()
    want = plain()
    diff = _differ(got, want)
    if diff:
        raise AssertionError(f"{label}: {diff} elements differ from the "
                             "plain version")
    if _differ(fn(), got):
        raise AssertionError(f"{label}: other bits on a second call")
    k = kernels_per_call(label, fn, reps=3, expected=expected_kernels)
    ms = time_ms(fn, reps=reps)
    plain_ms = time_ms(plain, reps=2, warmup=1)
    dev = device_ms([fn], 5)
    us = host_us([fn], 20)
    b, by = bound_ms(nbytes, 0.0, "f32")
    log(f"{label}: bit-equal to the plain version (every output), the same "
        f"bits twice; kernel {ms:.3f} ms (device {fmt_ms(dev)}), plain "
        f"{plain_ms:.3f} ms, bound {b:.4f} ms ({nbytes} bytes at "
        f"{HBM_BPS / 1e12:.2f} TB/s), {k:g} device kernels a call, "
        f"{us:.1f} us of host a call; library: none: {note}")
    return got, dict(max_abs_err=float(diff), ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=by, device_ms=dev, library_ms=None)


def sort_kernels(n: int):
    """(device kernels, device ms) of one torch.sort of n int64 keys: the
    one library call of K10's path."""
    import torch
    keys = torch.randint(0, 1 << 62, (n,), device="cuda")
    return (count_kernels(lambda: torch.sort(keys), reps=3)[0],
            device_ms([lambda: torch.sort(keys)], 5))


def check_coord_kernels(xyz, counts, inverse: bool, what: str):
    """K10 (`voxelize_batched`), K11 (`build_pyramid`) and K12
    (`conv_maps`, with the inverses where `inverse`) on one side of a
    batch, each against its plain version on the same CUDA tensors.
    Returns {kernels-line name: row}."""
    import torch
    from eyoc_tpu_torch.sparse import bricks, brick_conv, morton
    from eyoc_tpu_torch.sparse import voxelize as vz
    from eyoc_tpu_torch.training.pipeline import brick_caps
    B, P = xyz.shape[:2]
    cap, bcs = CAPS[0], brick_caps(CAPS)
    n_sort, sort_ms = sort_kernels(B * P)
    tag = f"({what}, B = {B}, P = {P})"
    # torch divides a CUDA tensor by a Python number as a product with its
    # reciprocal: the points where that moves the quantized coordinate
    pts = xyz.reshape(-1, 3)
    moved = int((torch.floor(pts / 0.3) != torch.floor(
        pts / torch.tensor(0.3, device="cuda"))).any(1).sum())
    log(f"quantize {tag}: torch's x / 0.3 on the card moves {moved} of "
        f"{pts.shape[0]} points to another voxel than the IEEE division "
        "(the plain version and K10 divide by a device tensor, IEEE)")
    args = (xyz, counts, 0.3, cap, WINDOW_BITS)
    (vox, keys), r10 = _coord_row(
        f"K10 voxelize {tag}", lambda: vz.voxelize_batched(*args),
        lambda: vz.voxelize_batched_plain(*args),
        xyz.numel() * 4 + B * 4 + B * 4 + B * cap * (12 + 12 + 1 + 4 + 4),
        2 + n_sort, "no one call quantizes, sorts and compacts with a "
        "representative point", reps=5)
    log(f"  K10's torch.sort of {B * P} int64 keys: {n_sort:g} device "
        f"kernels, device {fmt_ms(sort_ms)}, bound "
        f"{bound_ms(B * P * 16, 0.0, 'f32')[0]:.4f} ms (the keys read once "
        "and written once)")
    mask0 = vox.mask.reshape(-1)
    pargs = (keys, mask0, B, bcs, WINDOW_BITS)
    pyr, r11 = _coord_row(
        f"K11 brick_pyramid {tag}", lambda: bricks.build_pyramid(*pargs),
        lambda: bricks.build_pyramid_plain(*pargs),
        keys.numel() * 5 + _nbytes(bricks.build_pyramid(*pargs)), 2,
        "no one call groups sorted keys into bricks and finds neighbours")
    gx, gy, gz = morton.grid_dims(1, WINDOW_BITS)
    log(f"  K11 allocates no dense grid; the plain version's level-0 grid "
        f"is {B * gx * gy * gz * 4 / 2 ** 20:.1f} MiB")
    margs = (pyr, 4, 5, inverse)
    _, r12 = _coord_row(
        f"K12 conv_maps {tag}, inverse {inverse}",
        lambda: brick_conv.conv_maps(*margs),
        lambda: brick_conv.conv_maps_plain(*margs),
        sum(_nbytes((lv.nbr6, lv.cellslot, lv.occ, lv.up_slots))
            for lv in pyr.levels) + _nbytes(brick_conv.conv_maps(*margs)[:4])
        + _nbytes(brick_conv.conv_maps(*margs)[5:]), 2,
        "no one call builds gather maps from a brick pyramid")
    return {"voxelize": r10, "brick_pyramid": r11, "conv_maps": r12}


def coord_path_checks(what, xyz, counts, inverse: bool):
    """One side of a path's batch through `preprocess_clouds` and
    `conv_maps`: the device kernels of a preprocess call (K10's 2, the
    sort's and K11's 2) beside the plain version's (the parent's code) on
    the same CUDA tensors; no host sync (sync debug mode "error") in
    preprocess_clouds and conv_maps, with the inverses where `inverse`
    (their collision count is read by the conv backward: a pyramid forced
    to collide raises there, at the first backward, and not in the call);
    the preprocess's peak device memory beside the plain version's and
    under the plain version's level-0 dense grid."""
    import torch
    from eyoc_tpu_torch.sparse import morton
    from eyoc_tpu_torch.sparse.brick_conv import conv_maps
    from eyoc_tpu_torch.training.pipeline import (preprocess_clouds,
                                                  preprocess_clouds_plain)
    kw = dict(caps=CAPS, voxel_size=0.3, window_bits=WINDOW_BITS)
    B, P = xyz.shape[:2]
    n_sort = sort_kernels(B * P)[0]
    k = count_kernels(lambda: preprocess_clouds(xyz, counts, **kw), 3)[0]
    k_plain = count_kernels(lambda: preprocess_clouds_plain(xyz, counts,
                                                            **kw), 1)[0]
    if k != 4 + n_sort:
        raise AssertionError(f"{what}: preprocess_clouds runs {k:g} device "
                             f"kernels, not K10's 2 + the sort's {n_sort:g} "
                             "+ K11's 2")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, pyr = preprocess_clouds(xyz, counts, **kw)
        conv_maps(pyr, 4, 5)
        if inverse:
            conv_maps(pyr, 4, 5, inverse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if inverse:
        forced_collision_raises(what, pyr)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()          # alive until the peak is read
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        del out
        return extra
    mem = peak(lambda: preprocess_clouds(xyz, counts, **kw))
    mem_plain = peak(lambda: preprocess_clouds_plain(xyz, counts, **kw))
    gx, gy, gz = morton.grid_dims(1, WINDOW_BITS)
    grid = B * gx * gy * gz * 4
    if mem >= grid:
        raise AssertionError(f"{what}: preprocess_clouds peaks at {mem} "
                             f"bytes, no less than a {grid}-byte grid")
    log(f"{what} (B = {B}, P = {P}): preprocess_clouds runs {k:g} device "
        f"kernels (K10 2, the sort {n_sort:g}, K11 2; the plain version "
        f"{k_plain:g} on the same tensors), no host sync in it or in "
        f"conv_maps(inverse={inverse}) (sync debug mode \"error\")"
        f"; peak device memory {mem / 2 ** 20:.1f} MiB (the plain "
        f"version {mem_plain / 2 ** 20:.1f} MiB, its level-0 grid "
        f"{grid / 2 ** 20:.1f} MiB)")


def forced_collision_raises(what, pyr):
    """K12's deferred collision check on the card: every level-0 brick
    takes one brick as its +z neighbour, so outputs of different bricks
    read one input through one tap. conv_maps(inverse=True) returns with
    no host sync (mode "error"), and the first conv backward over one of
    its inverses raises as invert_map does, before dX reads it."""
    import torch
    from eyoc_tpu_torch.sparse.brick_conv import (SparseConvFunction,
                                                  conv_maps)
    lv = pyr.levels[0]
    target = int(lv.occ.reshape(-1, 8)[:, 0::2].sum(1).argmax())
    nbr6 = lv.nbr6.clone()
    nbr6[5] = torch.where(lv.bmask, torch.full_like(nbr6[5], target),
                          nbr6[5])
    bad = pyr._replace(levels=(lv._replace(nbr6=nbr6),) + pyr.levels[1:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        maps = conv_maps(bad, 4, 5, inverse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((lv.cellslot.shape[0], 32), device="cuda",
                    generator=gen).bfloat16().requires_grad_()
    W = torch.randn((27, 32, 32), device="cuda", generator=gen)
    out = SparseConvFunction.apply(x, None, W, maps.same3[0],
                                   maps.inv_same3[0])
    try:
        out.float().sum().backward()
    except ValueError as err:
        if "read by more than one output row" not in str(err):
            raise
        log(f"{what}: a forced collision (every brick's +z neighbour one "
            f"brick): conv_maps(inverse=True) returned with no host sync; "
            f"the first conv backward raised: {err}")
        return
    raise AssertionError(f"{what}: a forced collision did not raise at the "
                         "conv backward")


# ---------------------------------------------------- phase 2, training


COORD_KERNELS = ("voxelize", "brick_pyramid", "conv_maps")
TRAIN_KERNELS = ("sparse_conv", "sparse_conv_dgrad", "masked_argmin",
                 "sparse_conv_wgrad", "take_rows", "take_rows_backward",
                 "masked_channel_sums", "masked_norm_apply",
                 "masked_norm_backward_bn") + COORD_KERNELS
EVAL_KERNELS = ("sparse_conv", "masked_argmin", "sc2_power_iteration",
                "sc2_seed_topk", "sc2_nms", "sc2_seed_transforms",
                "sc2_irls") + COORD_KERNELS


def make_train_batch():
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
    ds = SyntheticPairs(n_pairs=TRAIN_B, n_points=RAW, dist=TRAIN_DIST,
                        phase="train", voxel_size=0.3)
    return collate_items([ds[i] for i in range(TRAIN_B)], RAW)


@contextlib.contextmanager
def recording(sites):
    """Record every call of the wrappers `sites` [(module, name)] while the
    block runs: yields {name: [(args, kwargs), ...]}."""
    calls = {name: [] for _, name in sites}
    real = {(mod, name): getattr(mod, name) for mod, name in sites}

    def recorder(mod, name):
        fn = real[(mod, name)]

        def rec(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return rec

    for mod, name in sites:
        setattr(mod, name, recorder(mod, name))
    try:
        yield calls
    finally:
        for mod, name in sites:
            setattr(mod, name, real[(mod, name)])


def record_train_step(model, opt, batch, cfg, gen):
    """One train step with every call of the training kernels' wrappers
    recorded: {wrapper name: [(args, kwargs), ...]}."""
    import torch
    from eyoc_tpu_torch.ops import rows
    from eyoc_tpu_torch.sparse import brick_conv, norm
    from eyoc_tpu_torch.training import loss, pipeline
    from eyoc_tpu_torch.training.steps import base_train_step

    sites = [(brick_conv, "sparse_conv"), (brick_conv, "sparse_conv_dgrad"),
             (brick_conv, "sparse_conv_wgrad"), (rows, "take_rows_gather"),
             (rows, "take_rows_backward"), (norm, "masked_channel_sums"),
             (norm, "masked_norm_apply"), (norm, "masked_norm_backward"),
             (pipeline, "masked_argmin_batched"), (loss, "masked_argmin")]
    with recording(sites) as calls:
        metrics = base_train_step(model, opt, batch, cfg, generator=gen,
                                  device="cuda")
    torch.cuda.synchronize()
    return calls, metrics


def check_calls(label, calls, fn, plain, cost, close, library=None,
                reps=5, classify=None):
    """Kernel against plain version on each recorded call; the times and
    bounds are summed over the calls. With `library`, the kernel and the
    library call are timed in LIBRARY_ROUNDS rounds that alternate which
    goes first, and each side takes its median round. With `classify`, the
    kernel time and bound are also summed by class."""
    import torch
    with torch.no_grad():
        return _check_calls(label, calls, fn, plain, cost, close, library,
                            reps, classify)


def _check_calls(label, calls, fn, plain, cost, close, library, reps,
                 classify):
    import torch
    worst = ms = plain_ms = lib_ms = bound = tb = to = 0.0
    alt_bound, alt_kind = None, None
    classes = {}
    for args, kw in calls:
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        ok, err = close(got, want, *args, **kw)
        if not ok:
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            raise AssertionError(f"{label} {shapes} disagrees with its plain "
                                 f"version: max err {err}")
        worst = max(worst, err)

        def run():
            return fn(*args, **kw)
        if library is None:
            t = time_ms(run, reps=reps)
        else:
            # rounds that alternate which goes first; the median of each
            # side, so that a burst on the shared host in one round does
            # not decide a comparison of us-sized calls
            lib = library(*args, **kw)
            ks, ls = [], []
            for r in range(LIBRARY_ROUNDS):
                order = ((ks, run), (ls, lib)) if r % 2 == 0 else \
                    ((ls, lib), (ks, run))
                for out, f in order:
                    out.append(time_ms(f, reps=reps))
            t = float(np.median(ks))
            lib_ms += float(np.median(ls))
        ms += t
        plain_ms += time_ms(lambda: plain(*args, **kw), reps=2, warmup=1)
        # a cost may add a second count of the same work, (ops, kind), on
        # another unit (K8: the f32 rate alone); its bound is logged and
        # kept beside the row's
        nbytes, ops, kind, *alt = cost(*args, **kw)
        tb += nbytes / HBM_BPS * 1e3
        to += op_ms(ops, kind)
        b = bound_ms(nbytes, ops, kind)[0]
        bound += b
        if alt:
            alt_kind = alt[0][1]
            alt_bound = (alt_bound or 0.0) + bound_ms(nbytes, *alt[0])[0]
        if classify is not None:
            c = classes.setdefault(classify(*args, **kw), [0, 0.0, 0.0, []])
            c[0] += 1
            c[1] += t
            c[2] += b
            c[3].append((args, kw))
    dev = device_ms([lambda a=a, k=k: fn(*a, **k) for a, k in calls],
                    min(reps, 50))
    log(f"{label}: {len(calls)} calls, max abs err "
        f"{worst:.3e}, kernel {ms:.3f} ms (device {fmt_ms(dev)}), plain "
        f"{plain_ms:.3f} ms, "
        + (f"library {lib_ms:.3f} ms, " if library is not None else "")
        + f"bound {bound:.4f} ms")
    if alt_bound is not None:
        log(f"  bound {alt_bound:.4f} ms with the operations at the "
            f"{alt_kind} rate alone; device time at "
            + ("not measured" if dev is None else
               f"{bound / dev:.3f} of the row's bound, {alt_bound / dev:.3f} "
               f"of that one"))
    for name, (n, t, b, cl) in classes.items():
        d = device_ms([lambda a=a, k=k: fn(*a, **k) for a, k in cl],
                      min(reps, 50))
        log(f"  {name}: {n} calls, kernel {t:.3f} ms (device {fmt_ms(d)}), "
            f"bound {b:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if tb >= to else "operations",
                library_ms=lib_ms if library is not None else None,
                device_ms=dev, bound_alt_ms=alt_bound)


def _bf16_close(rtol, atol_frac):
    """K1's tolerance style: rtol of each value plus a fraction of the
    largest."""
    def close(got, want, *args, **kw):
        got, want = got.float(), want.float()
        if want.numel() == 0:
            return True, 0.0
        err = (got - want).abs()
        scale = max(float(want.abs().max()), 1e-6)
        return bool((err <= rtol * want.abs() + atol_frac * scale).all()), \
            float(err.max())
    return close


def _conv_cost(x, W, nmap, x2=None, bias=None, mask=None, residual=None,
               **_):
    T, Ci, Co = W.shape
    M_in, M_out = x.shape[0], nmap.shape[0]
    taps = int(((nmap >= 0) & (nmap < M_in)).sum())
    nbytes = M_in * Ci * 2 + T * Ci * Co * 2 + M_out * T * 4 + M_out * Co * 2
    nbytes += sum(t.numel() * t.element_size()
                  for t in (bias, mask, residual) if t is not None)
    return nbytes, 2.0 * taps * Ci * Co, "bf16"


def _conv_class(x, W, nmap, **_):
    """K1's shape classes, from the shape alone: a narrow input (conv1: one
    channel, which the kernel packs into K), 1x1 (one tap), coarse (fewer
    64 x 64 output tiles than 264, two for each SM: where the kernel splits
    the taps) and fine."""
    T, Ci, Co = W.shape
    if Ci % 8:
        return "narrow input (conv1)"
    if T == 1:
        return "1x1"
    tiles = -(-nmap.shape[0] // 64) * -(-Co // 64)
    return "coarse" if tiles < 264 else "fine"


def _wgrad_cost(x, dy, nmap, x2=None):
    Ci = x.shape[1] + (0 if x2 is None else x2.shape[1])
    M_in, (M_out, T), Co = x.shape[0], nmap.shape, dy.shape[1]
    taps = int(((nmap >= 0) & (nmap < M_in)).sum())
    nbytes = M_in * Ci * 2 + M_out * Co * 2 + M_out * T * 4 + T * Ci * Co * 4
    return nbytes, 2.0 * taps * Ci * Co, "bf16"


def _wgrad_class(x, dy, nmap, x2=None):
    """K5's shape classes, from the shape alone: a narrow input (conv1: one
    channel, which the kernel packs into M), 1x1 (one tap), coarse (levels
    2 and 3 at B = 8: fewer than 16384 output rows) and fine."""
    from eyoc_tpu_torch.sparse.brick_conv import k5_plan
    M_out, T = nmap.shape
    cb = 0 if x2 is None else x2.shape[1]
    if k5_plan(M_out, T, x.shape[1], cb, dy.shape[1]).packed:
        return "narrow input (conv1)"
    if T == 1:
        return "1x1"
    return "coarse" if M_out < 16384 else "fine"


def _gather_cost(src, idx):
    import torch
    ok = (idx >= 0) & (idx < src.shape[0])
    rows = int(torch.unique(idx[ok]).numel())
    row_bytes = src[0].numel() * src.element_size()
    return rows * row_bytes + idx.numel() * 4 + idx.numel() * row_bytes, \
        0.0, "f32"


def _scatter_cost(dout, idx, n_src):
    return (dout.numel() * dout.element_size() + idx.numel() * 4
            + n_src * dout.shape[1] * 4), float(dout.numel()), "f32"


def _gather_close(got, want, *a):
    """K6 forward: the same bits."""
    import torch
    return bool(torch.equal(got, want)), float(
        (got.float() - want.float()).abs().max()) if got.numel() else 0.0


def _index_select(src, idx):
    """K6's library call (no sentinel reaches it on the loss path)."""
    import torch
    if bool(((idx < 0) | (idx >= src.shape[0])).any()):
        raise AssertionError("take_rows: a sentinel on the loss path")
    idx64 = idx.long()
    return lambda: torch.index_select(src, 0, idx64)


def _scatter_close(got, want, *a):
    """K6 backward: f32 atomics against index_add_'s order."""
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return bool(torch.allclose(got, want, rtol=K6B_RTOL,
                               atol=K6B_ATOL)), err


def _index_add(dout, idx, n_src):
    """K6 backward's library call."""
    import torch
    idx64 = idx.long()
    d = dout.float()
    return lambda: torch.zeros((n_src, d.shape[1]), dtype=torch.float32,
                               device=d.device).index_add_(0, idx64, d)


def _sums_cost(x, mask, y=None, shift=None):
    e = x.element_size()
    nbytes = x.numel() * e + mask.numel() + (1 + 2 * x.shape[1]) * 4
    if y is not None:
        nbytes += y.numel() * e + x.shape[1] * 4
    return nbytes, 3.0 * x.numel(), "f32"


def _sums_class(x, mask, y=None, shift=None):
    """K7's shape classes: rows, channels and direction (the forward's
    statistics, or the backward's with y and shift)."""
    way = "backward" if y is not None else "forward"
    return f"{x.shape[0]} x {x.shape[1]} {way}"


def _k2(q, qm, r, rm):
    """K2 as the main paths call it: batched ([B, N, D], the GT pairs) or
    one problem (the mining, the eval matching)."""
    from eyoc_tpu_torch.ops import knn
    fn = knn.masked_argmin_batched if q.dim() == 3 else knn.masked_argmin
    return fn(q, qm, r, rm)


def _k2_plain(q, qm, r, rm):
    from eyoc_tpu_torch.ops import knn
    fn = (knn.masked_argmin_batched_plain if q.dim() == 3
          else knn.masked_argmin_plain)
    return fn(q, qm, r, rm)


def _argmin_cost(q, qm, r, rm):
    D = q.shape[-1]
    nq, nr = qm.numel(), rm.numel()
    pairs = float((qm.reshape(-1, qm.shape[-1]).sum(1).double()
                   * rm.reshape(-1, rm.shape[-1]).sum(1).double()).sum())
    return (nq + nr) * D * 4 + nq + nr + nq * 8, 2.0 * pairs * D, "f32"


def _argmin_class(q, qm, r, rm):
    """K2's classes on the train path: the GT pairs (D = 3, all items in
    one batched call) and the loss's mining (D = 32)."""
    if q.dim() == 3:
        return f"GT pairs, D = {q.shape[-1]}, batch {q.shape[0]}"
    return f"mining, D = {q.shape[-1]}"


def _argmin_close(got, want, q, qm, r, rm, gap=K2_GAP):
    """K2 against the plain version's Gram form: d2 within K2_D2_RTOL plus
    the Gram form's rounding (1e-6 of |q|^2 + max |r|^2, about 8 f32 ulps of
    its terms: coordinates reach 76 m); indices equal where the gap between
    the first and second nearest valid ref (f64, direct form) is clear of
    K2_GAP and that rounding."""
    import torch
    (d_k, i_k), (d_p, i_p) = got, want
    if q.dim() == 3:               # a batch: each problem on its own
        res = [_argmin_close((d_k[b], i_k[b]), (d_p[b], i_p[b]), q[b],
                             qm[b], r[b], rm[b], gap)
               for b in range(q.shape[0])]
        return all(ok for ok, _ in res), max((e for _, e in res),
                                             default=0.0)
    if d_k.numel() == 0:
        return True, 0.0
    gram = 1e-6 * ((q * q).sum(1) + float((r * r).sum(1).max()))
    err = (d_k - d_p).abs()
    ok = bool((err <= K2_D2_RTOL * d_p.abs() + gram).all())
    full = torch.cdist(q.double(), r.double(),
                       compute_mode="donot_use_mm_for_euclid_dist") ** 2
    full += torch.where(rm, 0.0, 1e30).double()[None]
    two = torch.topk(full, 2, largest=False).values
    del full
    clear = qm & ((two[:, 1] - two[:, 0]) > gap + 2 * gram)
    ok = ok and bool(torch.equal(i_k[clear], i_p[clear]))
    return ok, float(err[qm].max()) if bool(qm.any()) else 0.0


def _sums_close(got, want, x, mask, y=None, shift=None):
    from eyoc_tpu_torch.sparse.norm import masked_channel_sums_plain
    yabs = None if y is None else (y.float() - (0 if shift is None
                                                else shift)).abs()
    scale = masked_channel_sums_plain(x.float().abs(), mask, yabs)
    err = (got - want).abs()
    return bool((err <= K7_REL * scale + 1e-6).all()), float(err.max())


def check_train_kernels(calls):
    """K1 (the train forward), K1 as dgrad, K2 (GT pairs and mining), K5,
    K6 and its backward, K7 on the recorded calls of one train step, plus
    K6 at the TPU probes' shape. K1 and K2 also run on the eval path: their
    rows here carry the suffix `_train`."""
    import torch
    from eyoc_tpu_torch.ops import knn, rows
    from eyoc_tpu_torch.sparse import brick_conv as bc
    from eyoc_tpu_torch.sparse import norm

    conv_close = _bf16_close(K1_RTOL, K1_ATOL_FRAC)
    out = {}
    out["sparse_conv_train"] = check_calls(
        "K1 sparse_conv, train forward of one step", calls["sparse_conv"],
        bc.sparse_conv, bc.sparse_conv_plain, _conv_cost, conv_close,
        classify=_conv_class)
    k2_calls = calls["masked_argmin_batched"] + calls["masked_argmin"]
    out["masked_argmin_train"] = check_calls(
        "K2 masked_argmin, one train step (GT pairs at D = 3 in one batched "
        "call, mining at D = 32)", k2_calls, _k2, _k2_plain, _argmin_cost,
        _argmin_close, classify=_argmin_class)
    # the last block of a query tile adds the splits in split order
    same_bits_twice("K2 masked_argmin (train)", _k2, k2_calls)
    launch_path("K2 masked_argmin (train)", _k2, k2_calls, "one train step",
                20)
    (gq, gqm, gr, grm), _ = calls["masked_argmin_batched"][0]
    kernels_per_call("K2 masked_argmin_batched (the GT pairs of a step)",
                     lambda: knn.masked_argmin_batched(gq, gqm, gr, grm))
    out["sparse_conv_dgrad"] = check_calls(
        "K1 sparse_conv_dgrad, one train step", calls["sparse_conv_dgrad"],
        bc.sparse_conv_dgrad,
        lambda dy, Wt, inv: bc.sparse_conv_plain(dy, Wt, inv), _conv_cost,
        conv_close, classify=_conv_class)
    out["sparse_conv_wgrad"] = check_calls(
        "K5 sparse_conv_wgrad, one train step", calls["sparse_conv_wgrad"],
        bc.sparse_conv_wgrad, bc.sparse_conv_wgrad_plain, _wgrad_cost,
        _bf16_close(K5_RTOL, K5_ATOL_FRAC), classify=_wgrad_class)
    # row splits added in split order: the same bits twice
    same_bits_twice("K5 sparse_conv_wgrad", bc.sparse_conv_wgrad,
                    calls["sparse_conv_wgrad"])
    launch_path("K5 sparse_conv_wgrad", bc.sparse_conv_wgrad,
                calls["sparse_conv_wgrad"], "one train step", 5)

    out["take_rows"] = check_calls(
        "K6 take_rows, one train step", calls["take_rows_gather"],
        rows.take_rows_gather,
        rows.take_rows_plain, _gather_cost, _gather_close, _index_select,
        reps=SMALL_REPS)
    out["take_rows_backward"] = check_calls(
        "K6 take_rows_backward, one train step", calls["take_rows_backward"],
        rows.take_rows_backward, rows.take_rows_backward_plain, _scatter_cost,
        _scatter_close, _index_add, reps=SMALL_REPS)
    out["masked_channel_sums"] = check_calls(
        "K7 masked_channel_sums, one train step",
        calls["masked_channel_sums"],
        norm.masked_channel_sums, norm.masked_channel_sums_plain, _sums_cost,
        _sums_close, reps=SMALL_REPS, classify=_sums_class)
    # chunk partials added by a fixed tree: the same bits twice
    same_bits_twice("K7 masked_channel_sums", norm.masked_channel_sums,
                    calls["masked_channel_sums"])
    launch_path("K7 masked_channel_sums", norm.masked_channel_sums,
                calls["masked_channel_sums"], "one train step", 20)
    out.update(check_norm_kernels(calls, "one ResUNetBN2C train step"))

    gen = torch.Generator().manual_seed(4)
    src = torch.randn(PROBE_ROWS, PROBE_COLS, generator=gen).to(
        torch.bfloat16).cuda()
    idx = torch.randint(0, PROBE_ROWS, (PROBE_ROWS,), generator=gen).to(
        torch.int32).cuda()
    check_calls(f"K6 take_rows at the TPU probe shape [{PROBE_ROWS}, "
                f"{PROBE_COLS}] bf16", [((src, idx), {})],
                rows.take_rows_gather, rows.take_rows_plain, _gather_cost,
                _gather_close, _index_select, reps=SMALL_REPS)

    # the launch path alone: host time per call, not waited for
    (lsrc, lidx), _ = calls["take_rows_gather"][0]
    for what, table, at in (
            (f"a loss call {tuple(lsrc.shape)} -> {tuple(lidx.shape)}", lsrc,
             lidx), ("the probe shape", src, idx)):
        at64 = at.long()
        k = host_us([lambda: rows.take_rows_gather(table, at)], 200)
        lib = host_us([lambda: torch.index_select(table, 0, at64)], 200)
        log(f"K6 take_rows launch path at {what}: {k:.2f} us of host time "
            f"per call, torch.index_select {lib:.2f} us (200 calls)")
    return out


# ---------------------------------------------------- phase 2, SC2-PCR


SC2_KERNELS = ("sc2_nms", "sc2_seed_transforms", "sc2_irls")
# a fitness or IRLS inlier test may come out otherwise than the plain
# version's only for a point whose f64 distance lies within SC2_EPS of the
# threshold, plus (K14) as far as the two poses move it
SC2_EPS = 1e-4                       # m
# K14's and K15's poses are held to the same solve in f64 (`_solve64`: QCP,
# or for K23 / K24 the port's 8-sweep Jacobi; K14 on the plain version's
# consensus points and weights, K15 every IRLS round, `_irls64`): a valid
# row moves by at most SC2_DISP plus the f32 rounding reach C * 2^-24 *
# lever * E / gap, where E = sum w |a - cA| |b - cB| (the moments' terms),
# gap the Horn matrix's leading eigengap (2 (s2 + s3) for a proper
# rotation) and lever the valid rows' largest distance from cA. C is read
# in the same run: SC2_C_FACTOR times the plain version's own largest
# ratio of its distance from the f64 solve to 2^-24 * lever * E / gap (at
# least 1), over the seeds (K14) or problems (K15) whose weighted sets pin
# a pose
SC2_DISP = 1e-3                      # m
SC2_C_FACTOR = 2.0
# a weighted set pins a pose where its weights keep at least half their
# mass (K14's |v| + 1e-6 normalization did not swallow them), 3 rows or
# more carry weight, and the Horn gap is at least SC2_GAP of max|H|
SC2_GAP = 1e-2
U32 = 2.0 ** -24
# the labeling shape's synthetic problems (inlier share, valid rows), the
# valid rows first as compact_matches leaves them
LABEL_SPEC = ((0.3, LABEL_N), (0.1, LABEL_N), (0.3, LABEL_N // 2),
              (0.05, LABEL_N), (0.3, 500), (0.5, 123), (0.3, 10), (0.0, 0))


# the IRLS rounds of the refine_unroll rows and phase 4's unroll runs
UNROLL = 4


def jacobi_eval_set():
    """The eval shape's problem of the Jacobi rows (K23, K24, the unroll
    rows): B = 1, N = 5000 at 30% inliers, 50 rows invalid."""
    import torch
    return sc2_problems(torch.Generator().manual_seed(22), N_CORR,
                        ((0.3, N_CORR - 50),))[:3]


def jacobi_label_set():
    """The labeling shape's synthetic problems of the Jacobi `_label` rows
    (B = 8, N = 8000: LABEL_SPEC)."""
    import torch
    return sc2_problems(torch.Generator().manual_seed(23), LABEL_N,
                        LABEL_SPEC)[:3]


# sha1 digests (first 16 hex digits) of K23's outputs (trans, fitness, best,
# fine_out) on jacobi_eval_set's and jacobi_label_set's K23 calls, made by
# K23's first design (its Jacobi solves inside the consensus launch) on the
# card and toolchain of K23_DIGEST_KEY (`k23_digest_key`; profile_k19_k23.py
# prints both): K23 must keep those bits
K23_DIGEST_KEY = "NVIDIA H100 80GB HBM3 | CUDA 12.8 | torch 2.11.0+cu128"
K23_DIGESTS = {"eval": "7dbbe9fa70fc3371", "label": "aa8cacf5259037fb"}


def k23_digest_key():
    """The card, CUDA and torch a digest of K23's outputs was made on."""
    import torch
    return (f"{torch.cuda.get_device_name(0)} | CUDA {torch.version.cuda} "
            f"| torch {torch.__version__}")


def sc2_digest(outs) -> str:
    """sha1 (16 hex digits) of a call's output tensors (a K14 / K23 call's
    tuple, or one tensor; None skipped)."""
    import hashlib
    h = hashlib.sha1()
    for t in (outs,) if hasattr(outs, "detach") else outs:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def check_k23_digests(label, calls):
    """K23's outputs on the recorded call `calls` against its first
    design's digests (K23_DIGESTS[label]), where this card and toolchain
    are the ones they were made on; elsewhere the digest is logged only."""
    from eyoc_tpu_torch.registration import sc2pcr
    (args, kw), = calls["sc2_seed_transforms"]
    got = sc2_digest(sc2pcr.sc2_seed_transforms(*args, **kw))
    key = k23_digest_key()
    want = K23_DIGESTS.get(label)
    if want is None or key != K23_DIGEST_KEY:
        log(f"K23 digest ({label}): {got} (no digest of the first design "
            f"recorded for {key})")
        return
    if got != want:
        raise AssertionError(f"K23 ({label}): outputs {got}, its first "
                             f"design gave {want} on {key}")
    log(f"K23 digest ({label}): {got}, the first design's bits")


def sc2_problems(gen, n, spec):
    """Known-pose problems of n correspondences (`correspondences`), one
    for each (inlier share, valid rows) of `spec`: src, tgt [B, n, 3],
    valid [B, n], T [B, 4, 4]."""
    import torch
    rows = []
    for inlier, nv in spec:
        src, tgt, valid, T = correspondences(gen, n=n, inlier=inlier)
        valid[nv:] = False
        rows.append((src, tgt, valid, T))
    return tuple(torch.stack([r[i] for r in rows]) for i in range(4))


def sc2_calls(src, tgt, valid, cfg):
    """K13's, K14's and K15's arguments on B problems, each from the
    kernels before it, as `sc2_pcr_batched` makes them."""
    import torch
    from eyoc_tpu_torch.registration import sc2pcr
    n = valid.shape[1]
    conf = torch.stack([sc2pcr.sc2_power_iteration(
        src[b], tgt[b], valid[b], cfg.d_thre, cfg.num_iterations)
        for b in range(src.shape[0])]) * valid.float()
    k13 = (src, valid, conf, cfg.nms_radius, min(cfg.num_seeds, n))
    seeds, seed_ok = sc2pcr.sc2_nms(*k13)
    knn = torch.stack([sc2pcr.sc2_seed_topk(src[b], tgt[b], valid[b],
                                            seeds[b], cfg.d_thre, cfg.k1)
                       for b in range(src.shape[0])])
    k14 = (cfg, seed_ok, knn, src, tgt, valid)
    trans, _, best, _ = sc2pcr.sc2_seed_transforms(*k14)
    k15 = (cfg, trans, best, src, tgt, valid)
    return {"sc2_nms": [(k13, {})], "sc2_seed_transforms": [(k14, {})],
            "sc2_irls": [(k15, {})]}


def _nms_close(got, want, *a):
    bad = _differ(got, want)
    return bad == 0, float(bad)


def _nms_cost(src, valid, scores, radius, num_seeds):
    """K13's bound: a radius test (9 flops) of each valid row against each
    valid row of larger score if it is a local maximum, else against one
    (its suppressor: at least one test); bytes: the points, valid flags
    and scores read once, the seeds and seed_ok written."""
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import _masked_dist
    B, n = valid.shape
    tests = 0.0
    for b in range(B):
        v, sc = valid[b], scores[b]
        larger = (sc[None, :] > sc[:, None]) & v[None, :] & v[:, None]
        supp = (larger & (_masked_dist(src[b], v) < radius)).any(1)
        need = torch.where(supp, torch.ones_like(supp, dtype=torch.int64),
                           larger.sum(1))
        tests += float(need[v].sum())
        del larger
    return B * n * (12 + 1 + 4) + B * num_seeds * 5, 9.0 * tests, "f32"


def _pose_dists(T, s64, t64, chunk=256):
    """f64 |R s + t - t| [S, M] of poses T [S, 4, 4] on rows s64/t64."""
    import torch
    out = []
    for i in range(0, T.shape[0], chunk):
        T64 = T[i:i + chunk].double()
        pred = (torch.einsum("sij,nj->sni", T64[:, :3, :3], s64)
                + T64[:, None, :3, 3])
        out.append((pred - t64[None]).norm(dim=-1))
    return torch.cat(out)


def _pose_disp(Ta, Tb, s64, chunk=256):
    """f64 max over rows s64 of |Ta s - Tb s|, for each pose [S]."""
    import torch
    out = []
    for i in range(0, Ta.shape[0], chunk):
        D = Ta[i:i + chunk].double() - Tb[i:i + chunk].double()
        move = (torch.einsum("sij,nj->sni", D[:, :3, :3], s64)
                + D[:, None, :3, 3])
        out.append(move.norm(dim=-1).amax(1) if s64.shape[0] else
                   torch.zeros(D.shape[0], dtype=torch.float64,
                               device=D.device))
    return torch.cat(out)


def _moments64(a, b, w):
    """The weighted set's centroids, centred rows, max|H| and the Horn
    matrix's inputs as the plain version forms them (geometry/svd3.
    kabsch_qcp), in the dtype of a, b [..., n, 3], w [..., n]: (cA, cB, am,
    bm, scale, Hn = H / scale, lam_upper)."""
    import torch
    wsum = w.sum(-1, keepdim=True) + 1e-6
    cA = (a * w[..., None]).sum(-2) / wsum
    cB = (b * w[..., None]).sum(-2) / wsum
    am, bm = a - cA[..., None, :], b - cB[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", am * w[..., None], bm)
    scale = H.abs().amax(dim=(-1, -2)).clamp(min=1e-12)
    Hn = H / scale[..., None, None]
    lam = (w * ((am * am).sum(-1) + (bm * bm).sum(-1))).sum(-1) / (2 * scale)
    return cA, cB, am, bm, scale, Hn, lam


def _newton64(Hn, lam):
    """The QCP root: 12 Newton steps on the quartic from lam_upper, with the
    1e-12 derivative guard (svd3.qcp_leading_quaternion)."""
    import torch
    from eyoc_tpu_torch.geometry import svd3
    c2, c1, c0 = svd3.qcp_quartic_coeffs(Hn)
    x = lam
    for _ in range(12):
        x2 = x * x
        dP = 4 * x2 * x + 2 * c2 * x + c1
        x = x - (x2 * x2 + c2 * x2 + c1 * x + c0) / torch.where(
            dP.abs() < 1e-12, torch.full_like(dP, 1e-12), dP)
    return x


def _qcp_tail64(N4, lam, x, col=None, d_col=None, d_pol=()):
    """The QCP solve from its root x on: the adjugate column of N4 - x I of
    largest norm (`col`, or the one given), q normalized (the identity
    quaternion where |q| <= 1e-12), 2 power steps on N4 + lam_upper I.
    d_col [..., 4] is added to the column and d_pol[i] [..., 4] to step i's
    product before its normalization (a rounding error, for `_qcp_reach`).
    Returns (q [..., 4], col, the iterates entering the two steps)."""
    import torch
    from eyoc_tpu_torch.geometry import svd3
    eye = torch.eye(4, dtype=N4.dtype, device=N4.device)
    adj = svd3._adjugate4_sym(N4 - x[..., None, None] * eye)
    if col is None:
        col = torch.argmax((adj * adj).sum(-2), -1)
    q = torch.gather(adj, -1, col[..., None, None].expand(
        adj.shape[:-1] + (1,)))[..., 0]
    if d_col is not None:
        q = q + d_col
    qn = q.norm(dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    q = torch.where(qn > 1e-12, q / (qn + 1e-30), ident)
    M = N4 + lam[..., None, None] * eye
    seen = []
    for i in range(2):
        seen.append(q)
        nq = torch.einsum("...ij,...j->...i", M, q)
        if i < len(d_pol):
            nq = nq + d_pol[i]
        n2 = (nq * nq).sum(-1, keepdim=True)
        q = torch.where(n2 > 1e-24, nq * torch.rsqrt(n2.clamp(min=1e-24)), q)
    return q, col, seen


def _solve64(a, b, w, jacobi=False):
    """The plain version's weighted QCP Kabsch (geometry/svd3.kabsch_qcp:
    centroids, centred moments, max|H| scaling, 12 Newton steps on the
    quartic, the adjugate column, 2 polish steps) in f64 on a, b [..., n,
    3], w [..., n]; with `jacobi`, its Jacobi Kabsch (geometry/svd3.kabsch:
    the same moments and Horn matrix, the eigenvector of the largest
    eigenvalue by `svd3.jacobi_eigh`'s 8 cyclic sweeps) in f64. Returns (T
    [..., 4, 4]; E / gap [...], the moments' rounding reach but for its
    lever and 2^-24; cA [..., 3]; whether the set pins a pose [...])."""
    import torch
    from eyoc_tpu_torch.geometry import svd3
    from eyoc_tpu_torch.geometry.se3 import integrate_trans
    cA, cB, am, bm, scale, Hn, lam = _moments64(a, b, w)
    N4 = svd3.horn_profile_matrix(Hn)
    if jacobi:
        ev, vecs = svd3.jacobi_eigh(N4, dtype=torch.float64)
        q = torch.gather(vecs, -1, ev.argmax(-1)[..., None, None].expand(
            vecs.shape[:-1] + (1,)))[..., 0]
        R = svd3.quat_to_rotmat(q)
        T = integrate_trans(R, cB - torch.einsum("...ij,...j->...i", R, cA))
        return _solve_outputs(T, ev.sort(-1).values, w, am, bm, scale, cA)
    ev = torch.linalg.eigvalsh(N4.cpu()).to(a.device)
    q = _qcp_tail64(N4, lam, _newton64(Hn, lam))[0]
    R = svd3.quat_to_rotmat(q)
    T = integrate_trans(R, cB - torch.einsum("...ij,...j->...i", R, cA))
    return _solve_outputs(T, ev, w, am, bm, scale, cA)


def _quartic_abs(Hn):
    """svd3.qcp_quartic_coeffs on |Hn| with every difference made a sum:
    each coefficient's sum of |terms|, the scale of its f32 rounding."""
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = (
        [Hn[..., i, j].abs() for j in range(3)] for i in range(3))
    sq = Sxx * Sxx + Syy * Syy + Szz * Szz + Sxy * Sxy + Syx * Syx \
        + Sxz * Sxz + Szx * Szx + Syz * Syz + Szy * Szy
    a2 = 2.0 * sq
    a1 = 8.0 * (Sxx * Syz * Szy + Syy * Szx * Sxz + Szz * Sxy * Syx
                + Sxx * Syy * Szz + Syz * Szx * Sxy + Szy * Syx * Sxz)
    p_xz, p_yz, p_xy = Sxz + Szx, Syz + Szy, Sxy + Syx
    xx_yy = Sxx + Syy
    t0 = Sxy * Sxy + Sxz * Sxz + Syx * Syx + Szx * Szx
    t1 = Syy * Syy + Szz * Szz + Sxx * Sxx + Syz * Syz + Szy * Szy
    t2 = 2.0 * (Syz * Szy + Syy * Szz)
    s3 = xx_yy + Szz
    f1 = p_xz * p_yz + p_xy * s3
    f2 = p_xy * p_yz + p_xz * s3
    a0 = t0 * t0 + (t1 + t2) ** 2 + 2.0 * (f1 * f1 + f2 * f2)
    return a2, a1, a0


def _det3_abs(a, b, c, d, e, f, g, h, i):
    return a * (e * i + f * h) + b * (d * i + f * g) + c * (d * h + e * g)


def _qcp_reach(a, b, w):
    """The f32 QCP solve's own rounding reach of each set's f64 pose, as
    `_weight_reach` makes the weights': each rounding source is moved by
    its first-order reach alone, the solve's tail run again in f64 from
    there (`_qcp_tail64`, the column held) and the rotation's move |dR|_F
    summed over the sources; a row at lever L from cA moves by at most that
    sum times L (t = cB - R cA: no move at cA). The sources, each u = 2^-24
    times the sum of |terms| of the arithmetic that rounds it:
    - the root: d_lam = u (x^4 + |c2| x^2 + |c1 x| + |c0| + A2 x^2 + A1 |x|
      + A0 + |x| |P'(x)|) / |P'(x)|, the quartic's terms at the root, its
      coefficients' (A_k their sums of |terms|, `_quartic_abs`) and the
      Newton update's, over the slope; carried into the adjugate column it
      turns the eigenvector by about d_lam / gap, and |P'| is about the
      gap times the other two gaps: the 1 / gap^2;
    - each adjugate entry alone, by u times its minor's sum of |cubic
      terms| (`_det3_abs` of |N4 - x I|), against a column of size about
      |P'(x)|;
    - each entry of each polish product alone, by u sum_j |M_ij q_j|.
    The polish's contraction ((lam_j + lam_upper) / (lam_1 + lam_upper))^2
    of the first two comes with the f64 tail. a, b [..., n, 3], w [..., n]
    f64 -> [...]."""
    import torch
    from eyoc_tpu_torch.geometry import svd3
    Hn, lam = _moments64(a, b, w)[5:]
    N4 = svd3.horn_profile_matrix(Hn)
    x = _newton64(Hn, lam)
    q0, col, seen = _qcp_tail64(N4, lam, x)
    R0 = svd3.quat_to_rotmat(q0)
    c2, c1, c0 = svd3.qcp_quartic_coeffs(Hn)
    a2, a1, a0 = _quartic_abs(Hn)
    x2 = x * x
    dP = (4 * x2 * x + 2 * c2 * x + c1).abs().clamp(min=1e-12)
    terms = (x2 * x2 + (c2 * x2).abs() + (c1 * x).abs() + c0.abs()
             + a2 * x2 + a1 * x.abs() + a0 + x.abs() * dP)
    moved = [_qcp_tail64(N4, lam, x + U32 * terms / dP, col)[0]]
    # each adjugate entry's rounding: the minors of |N4 - x I|
    eye = torch.eye(4, dtype=N4.dtype, device=N4.device)
    A = (N4 - x[..., None, None] * eye).abs()
    e = [[A[..., r, c] for c in range(4)] for r in range(4)]

    def minor_abs(r, c):
        rows = [k for k in range(4) if k != r]
        cols = [k for k in range(4) if k != c]
        return _det3_abs(*[e[rr][cc] for rr in rows for cc in cols])
    mabs = torch.stack([torch.stack([minor_abs(r, c) for c in range(4)], -1)
                        for r in range(4)], -2)
    # the adjugate's column col is the cofactors of row col (A symmetric)
    cof = torch.gather(mabs, -2, col[..., None, None].expand(
        mabs.shape[:-2] + (1, 4)))[..., 0, :]
    for i in range(4):
        d = (U32 * cof[..., i])[..., None] * eye[i]
        moved.append(_qcp_tail64(N4, lam, x, col, d_col=d)[0])
    # each polish product entry's rounding, at the unmoved iterates
    M = (N4 + lam[..., None, None] * eye).abs()
    for step in range(2):
        size = torch.einsum("...ij,...j->...i", M, seen[step].abs())
        for i in range(4):
            d = (U32 * size[..., i])[..., None] * eye[i]
            pol = [torch.zeros_like(d)] * step + [d]
            moved.append(_qcp_tail64(N4, lam, x, col, d_pol=pol)[0])
    return sum((svd3.quat_to_rotmat(qm) - R0).flatten(-2).norm(dim=-1)
               for qm in moved)


def _solve_outputs(T, ev, w, am, bm, scale, cA):
    """`_solve64`'s outputs from its pose T, the Horn matrix's eigenvalues
    ev (ascending, in units of max|H|) and its moments."""
    gap = ev[..., 3] - ev[..., 2]
    E = (w * am.norm(dim=-1) * bm.norm(dim=-1)).sum(-1) / scale
    pinned = ((w.sum(-1) >= 0.5) & ((w > 0).sum(-1) >= 3)
              & (gap >= SC2_GAP))
    return T, E / gap.clamp(min=1e-300), cA, pinned


def _consensus64(cfg, knn, src, tgt, valid):
    """The plain version's consensus (`sc2pcr._consensus`) with its soft
    matrix, power iteration and weights in f64 (the sets, from exact
    counts, as in f32): a, b [..., S, k2, 3] and w [..., S, k2], f64."""
    import torch
    from eyoc_tpu_torch.registration import sc2pcr
    fine_sel, a, b, _ = sc2pcr._consensus(cfg, knn, src, tgt, valid)
    nbr_ok = sc2pcr._seed_rows(valid[..., None], knn.long())[..., 0]
    fine_ok = torch.gather(nbr_ok, -1, fine_sel)
    a, b = a.double(), b.double()
    cross = (sc2pcr._pairwise_dist(a) - sc2pcr._pairwise_dist(b)).abs()
    sc = torch.clamp(1.0 - cross ** 2 / cfg.d_thre ** 2, min=0.0)
    k2 = fine_sel.shape[-1]
    keep = (fine_ok[..., :, None] & fine_ok[..., None, :]
            & ~torch.eye(k2, dtype=torch.bool, device=a.device))
    w = sc2pcr._power_iteration(torch.where(keep, sc, torch.zeros_like(sc)),
                                cfg.num_iterations)
    w = w.abs() * fine_ok
    return a, b, w / (w.sum(-1, keepdim=True) + 1e-6)


def _weight_reach(a, b, w, jacobi, iters, k2, solved):
    """The consensus weights' rounding reach of each seed's f64 pose: the
    kernel's weights come from the same `iters` power iterations over k2
    columns as the plain version's, summed in another fixed order, so each
    may differ from the plain version's by U32 * iters * k2 * |w| (the f32
    unit, compounded over the iterations and the k2-term sums). Each
    weight i is moved by that much alone and the pose solved again in f64
    (a finite difference along the weights' own rounding reach, a, b [...,
    k2, 3], w [..., k2] f64; `solved` the unmoved solve's `_solve64`
    outputs); a row s moves by (dR_i (s - cA) + dR_i cA + dt_i), at most
    |dR_i|_F |s - cA| + |dR_i cA + dt_i|. Returns (sum_i |dR_i|_F, sum_i
    |dR_i cA + dt_i|) [...]: the reach of a row at lever L from cA is rot
    * L + off, the first-order bound over every sign of the k2 rounding
    errors."""
    import torch
    T0, _, cA, _ = solved
    k = w.shape[-1]
    step = U32 * iters * k2 * w.abs()
    eye = torch.eye(k, dtype=w.dtype, device=w.device)
    lead = w.shape[:-1]
    wp = w[..., None, :] + step[..., :, None] * eye      # [..., k(i), k]
    ap = a[..., None, :, :].expand(lead + (k, k, 3))
    bp = b[..., None, :, :].expand(lead + (k, k, 3))
    D = _solve64(ap, bp, wp, jacobi=jacobi)[0] - T0[..., None, :, :]
    rot = D[..., :3, :3].flatten(-2).norm(dim=-1).sum(-1)
    off = (torch.einsum("...ij,...j->...i", D[..., :3, :3],
                        cA[..., None, :]) + D[..., :3, 3])
    return rot, off.norm(dim=-1).sum(-1)


def _lever(c, s64, chunk=256):
    """The largest distance of the rows s64 [M, 3] from each c [S, 3]."""
    import torch
    if not s64.shape[0]:
        return torch.zeros(c.shape[0], dtype=c.dtype, device=c.device)
    return torch.cat([torch.cdist(c[i:i + chunk], s64).amax(1)
                      for i in range(0, c.shape[0], chunk)])


def _seed_close(got, want, cfg, seed_ok, knn, src, tgt, valid, out=None):
    """K14 against its plain version on the same inputs:
    - the consensus sets (fine_sel) bit-equal;
    - on each seed whose weighted set pins a pose (`_solve64`), the kernel's
      pose within SC2_DISP plus C times the rounding reach of the f64 solve
      of the plain version's consensus points and weights (the solve's
      2^-24 lever E / gap plus the weights' rounding, `_weight_reach`), C
      read from the plain version's poses on the same seeds; the other
      seeds are counted and logged. Also logged: the ratios to the solve's
      reach alone, and both poses' ratios against the solve of the
      consensus carried in f64 from the points (`_consensus64`), which
      adds the f32 rounding of the k2 x k2 distances in the soft matrix;
    - each seed's fitness is the f64 count under the kernel's own pose but
      for tests within SC2_EPS of the threshold, -1 where the seed is not
      ok;
    - against the plain version's fitness, a test may flip only at a point
      that the two poses move across the threshold: within their largest
      displacement of a valid point plus SC2_EPS of it (f64);
    - best is the first argmax of the kernel's fitness and, up to those
      flips, a largest plain fitness.
    Returns the largest displacement of a valid row from the f64 pose over
    the seeds that pin one (m); `out`, a dict, takes the largest ratios
    (kernel, plain) to each reach, the seeds that pin a pose, C and the
    verdict."""
    import torch
    from eyoc_tpu_torch.registration import sc2pcr
    trans_k, fit_k, best_k, fine_k = got
    trans_p, fit_p, best_p, fine_p = want
    if not torch.equal(fine_k, fine_p):
        log("  K14: the consensus sets differ from the plain version's")
        return False, float("inf")
    jac = not cfg.qcp_kabsch
    _, a32, b32, w32 = sc2pcr._consensus(cfg, knn, src, tgt, valid)
    a64, b64, w64 = a32.double(), b32.double(), w32.double()
    solved = _solve64(a64, b64, w64, jacobi=jac)
    k2 = w32.shape[-1]
    weights = [_weight_reach(a64[i], b64[i], w64[i], jac, cfg.num_iterations,
                             k2, tuple(x[i] for x in solved))
               for i in range(a64.shape[0])]
    weights = tuple(torch.stack(x) for x in zip(*weights))
    # K14's reach adds the f32 QCP solve's own rounding; K23's Jacobi
    # solve keeps the moments' and the weights'
    qcp = None if jac else _qcp_reach(a64, b64, w64)
    d_k, d_p, solve_reach, pin, reach, full = _seed_reach(
        solved, trans_k, trans_p, src, valid, weights, qcp)
    del a32, b32, w32, a64, b64, w64
    ratios = {}
    for key, r in (("solve", solve_reach), ("weights", reach),
                   ("full", full)):
        ratios[key] = tuple(float((d / r)[pin].max()) if bool(pin.any())
                            else 0.0 for d in (d_k, d_p))
    kernel_ratio, plain_ratio = ratios["full"]
    C = SC2_C_FACTOR * max(plain_ratio, 1.0)
    held = bool((d_k <= SC2_DISP + C * full)[pin].all())
    if out is not None:
        out.update(ratios, pinned=int(pin.sum()), seeds=pin.numel(), C=C,
                   held=held)
    worst = float(d_k[pin].max()) if bool(pin.any()) else 0.0
    loose = float(d_k[~pin].max()) if bool((~pin).any()) else 0.0
    c_k, c_p, c_reach, c_pin, _, _ = _seed_reach(
        _solve64(*_consensus64(cfg, knn, src, tgt, valid), jacobi=jac),
        trans_k, trans_p, src, valid)
    chain = ((float((c_k / c_reach)[c_pin].max()),
              float((c_p / c_reach)[c_pin].max()),
              float(c_k[c_pin].max())) if bool(c_pin.any())
             else (0.0, 0.0, 0.0))

    thr = cfg.inlier_threshold
    ok, fworst, differ, banded = held, 0.0, 0, 0
    for b in range(valid.shape[0]):
        v = valid[b]
        s64, t64 = src[b][v].double(), tgt[b][v].double()
        so = seed_ok[b]
        dist = _pose_dists(trans_k[b], s64, t64)
        cnt = (dist < thr).sum(1).double()
        band = ((dist - thr).abs() <= SC2_EPS).sum(1).double()
        fk, fp = fit_k[b].double(), fit_p[b].double()
        own = torch.where(so, (fk - cnt).abs() <= band, fk == -1)
        disp = _pose_disp(trans_k[b], trans_p[b], s64)
        dist = _pose_dists(trans_p[b], s64, t64)
        slack = ((dist - thr).abs() <= disp[:, None] + SC2_EPS).sum(1)
        slack = torch.where(so, slack.double(), torch.zeros_like(fk))
        agree = (fk - fp).abs() <= slack
        bk, bp = int(best_k[b]), int(best_p[b])
        first = bk == int(torch.argmax(fit_k[b]))
        top = bool(fp[bk] + slack[bk] >= fp[bp] - slack[bp])
        ok &= bool(own.all()) and bool(agree.all()) and first and top
        fworst = max(fworst, float((fk - fp).abs().max()))
        differ += int((fk != fp).sum())
        banded += int((band > 0).sum())
        del dist
    log(f"  K14: consensus sets bit-equal; poses against the f64 solve of "
        f"the plain version's consensus points and weights, on the "
        f"{int(pin.sum())} of {pin.numel()} "
        f"seeds whose sets pin a pose: kernel within {worst:.3e} m, "
        f"largest ratio to the reach (2^-24 * lever * E / gap, the moments' "
        f"rounding, plus the weights', `_weight_reach`"
        + ("" if jac else ", plus the QCP solve's own, `_qcp_reach`")
        + f") {kernel_ratio:.3e} "
        f"(plain {plain_ratio:.3e}; held to {SC2_DISP} m + C = {C:.3e} "
        f"times it: {'yes' if held else 'NO'}); to the moments' reach alone "
        f"kernel {ratios['solve'][0]:.3e}, plain {ratios['solve'][1]:.3e}"
        + ("" if jac else f"; to the reach without the QCP solve's term "
           f"kernel {ratios['weights'][0]:.3e}, plain "
           f"{ratios['weights'][1]:.3e}") + "; "
        f"{int((~pin).sum())} seeds "
        f"whose sets pin none (weights swallowed by the 1e-6, under 3 rows "
        f"of weight, or a Horn gap under {SC2_GAP} of max|H|): kernel "
        f"within {loose:.3e} m; fitness: {differ} of {fit_k.numel()} seeds "
        f"differ from the plain version's (largest {fworst:g}), {banded} "
        f"with a test within {SC2_EPS} m of the threshold; best "
        f"{best_k.tolist()} (plain {best_p.tolist()}); against the f64 "
        f"solve of the consensus carried in f64 from the points (the f32 "
        f"rounding of the soft matrix's distances added): kernel within "
        f"{chain[2]:.3e} m, ratio {chain[0]:.3e}, plain {chain[1]:.3e}")
    return ok, worst


def _seed_reach(solved, trans_k, trans_p, src, valid, weights=None,
                qcp=None):
    """From `_solve64`'s outputs for every seed of B problems: the f64
    displacement of a valid row from the solve's pose under the kernel's
    and the plain version's poses trans_k, trans_p [B, S, 4, 4], the
    moments' rounding reach 2^-24 * lever * E / gap, whether each set pins
    a pose, (given `weights`, `_weight_reach`'s (rot, off) [B, S]) that
    reach plus the weights' rot * lever + off, else None, and that plus
    (given `qcp`, `_qcp_reach`'s [B, S]) the QCP solve's own qcp * lever;
    all flattened to [B * S]. A problem with no valid row pins nothing: its
    weights are all 0."""
    import torch
    T64, unit, cA, pinned = solved
    d_k, d_p, reach, full, solve = [], [], [], [], []
    for b in range(valid.shape[0]):
        s64 = src[b][valid[b]].double()
        lever = _lever(cA[b], s64)
        reach.append(U32 * unit[b] * lever)
        if weights is not None:
            full.append(reach[-1] + weights[0][b] * lever + weights[1][b])
            solve.append(full[-1] if qcp is None
                         else full[-1] + qcp[b] * lever)
        d_k.append(_pose_disp(trans_k[b], T64[b], s64))
        d_p.append(_pose_disp(trans_p[b], T64[b], s64))
    full, solve = ((torch.cat(full), torch.cat(solve)) if full
                   else (None, None))
    return (torch.cat(d_k), torch.cat(d_p), torch.cat(reach),
            pinned.reshape(-1), full, solve)


def _seed_cost(cfg, seed_ok, knn, src, tgt, valid):
    """K14's bound: for each head, a seed whose k1 columns differ from the
    seed before's (a seed with the columns of the seed before has its
    consensus and pose, bit for bit: the labeling's seeds past its valid
    rows all take the problem's first valid rows), the k1 x k1 distances of
    both clouds (9 flops each), the counts, the soft k2 x k2 matrix, the
    power iterations and the pose solve (`_solve_flops`), and per (head,
    valid row) the fitness test (25 flops); bytes: the points and flags
    once, the k1 columns, the poses, fitness and best written."""
    import torch
    B, S, k1 = knn.shape
    k2 = min(cfg.k2, k1)
    n = valid.shape[1]
    per_seed = (18 + 2) * k1 * k1 + 4 * k2 * k2 + cfg.num_iterations * (
        2 * k2 * k2 + 3 * k2) + _solve_flops(cfg)
    heads = torch.ones((B, S), dtype=torch.bool, device=knn.device)
    heads[:, 1:] = (knn[:, 1:] != knn[:, :-1]).any(-1)
    nh = heads.sum(1).double()
    ops = float((nh * (per_seed + 25.0 * valid.sum(1).double())).sum())
    log(f"  K14 bound: {int(nh.sum())} heads of {B * S} seeds")
    return (B * n * 25 + B * S * (k1 * 4 + 1) + B * S * 68 + B * 4, ops,
            "f32")


def _irls64(cfg, T, src, tgt, valid, it_num=20):
    """The plain per-problem IRLS (`sc2pcr._post_refine`, its stop or its
    `refine_unroll` rounds, the config's solve) in f64 from pose T: (the
    final pose, its rounds, and for each round (the least distance of a
    valid row's inlier test from the threshold, the inlier count, the pose
    it solves, its rounding reach (the moments' 2^-24 * lever * E / gap,
    plus for the QCP solve its own rounding's, `_qcp_reach`, times the
    lever), whether its set pins a pose, the moments' reach alone))."""
    from eyoc_tpu_torch.registration.sc2pcr import _irls_threshold
    thr = _irls_threshold(cfg)
    unroll = cfg.refine_unroll
    a, b, T = src.double(), tgt.double(), T.double()
    prev, cur, it, rounds = 0, 0, 0, []
    while (it < unroll if unroll > 0
           else it < it_num and (it == 0 or abs(cur - prev) >= 1)):
        dist = (a @ T[:3, :3].T + T[:3, 3] - b).norm(dim=-1)
        margin = (float((dist - thr).abs()[valid].min())
                  if bool(valid.any()) else float("inf"))
        inlier = (dist < thr) & valid
        w = (1.0 / (1.0 + (dist / thr) ** 2)) * inlier
        new, unit, cA, pinned = _solve64(a[None], b[None], w[None],
                                         jacobi=not cfg.qcp_kabsch)
        count = int(inlier.sum())
        lever = float(_lever(cA, a[valid])[0]) if count else 0.0
        moments = U32 * float(unit[0]) * lever
        reach = moments + (0.0 if not count or not cfg.qcp_kabsch else float(
            _qcp_reach(a[None], b[None], w[None])[0]) * lever)
        rounds.append((margin, count, new[0], reach,
                       bool(pinned[0]) or count == 0, moments))
        if count > 0:
            T = new[0]
        prev, cur, it = cur, count, it + 1
    return T, it, rounds


def _irls_close(got, want, cfg, trans, best, src, tgt, valid):
    """K15 against the plain IRLS run in f64 from the same start poses
    (`_irls64`), C read from the plain version's own runs: SC2_C_FACTOR
    times its largest ratio to the reach, over the one rounds and the
    whole runs held below (at least 1):
    - one round from the start, where its inlier tests are clear of the
      threshold by SC2_EPS and its set pins a pose: the kernel's pose within
      SC2_DISP + C times its rounding reach of the f64 round (the reading of
      the kernel's f32 moments and solve; K15's reach adds the QCP solve's
      own rounding, `_qcp_reach`, and its ratios to the reach without that
      term are logged too);
    - the whole run: the same rounds as the f64 run and the pose within
      SC2_DISP + C times the last round's reach, every round's set pinning
      a pose; or, where not, a round of the f64 run whose set pins no pose
      or whose inlier test lies within
      SC2_EPS plus C times the round before's reach of the threshold (f32
      may take another inlier set there), logged with its reaches and
      margins.
    Returns the largest displacement of a problem whose run agrees (m)."""
    import dataclasses
    from eyoc_tpu_torch.registration import sc2pcr
    (T_k, it_k), (T_p, it_p) = got, want
    one = dataclasses.replace(cfg, refine_unroll=0)
    one_k, _ = sc2pcr.sc2_irls(one, trans, best, src, tgt, valid, it_num=1)
    one_p, _ = sc2pcr.sc2_irls_plain(one, trans, best, src, tgt, valid,
                                     it_num=1)
    # the plain version's ratios (the first 1.0: C's floor) and the
    # kernel's one-round ratios, to the reach and to the moments' alone
    runs, r_p, o_p, r_k, o_k = [], [1.0], [0.0], [0.0], [0.0]
    for b in range(valid.shape[0]):
        v = valid[b]
        s64 = src[b][v].double()
        T64, it64, rounds = _irls64(cfg, trans[b, int(best[b])], src[b],
                                    tgt[b], v)
        margin, count, T1, reach1, pinned1, moments1 = rounds[0]
        first = None
        if count and pinned1 and margin > SC2_EPS and reach1 > 0:
            first = (float(_pose_disp(one_k[b:b + 1], T1[None], s64)[0]),
                     reach1)
            r_k.append(first[0] / reach1)
            o_k.append(first[0] / moments1)
            d1 = float(_pose_disp(one_p[b:b + 1], T1[None], s64)[0])
            r_p.append(d1 / reach1)
            o_p.append(d1 / moments1)
        solved = [r for r in rounds if r[1]]
        last, last_m = solved[-1][3::2] if solved else (0.0, 0.0)
        pins = all(r[4] for r in rounds)
        disp = float(_pose_disp(T_k[b:b + 1], T64[None], s64)[0])
        if int(it_p[b]) == it64 and pins and last > 0:
            dn = float(_pose_disp(T_p[b:b + 1], T64[None], s64)[0])
            r_p.append(dn / last)
            o_p.append(dn / last_m)
        runs.append((first, it64, rounds, last, pins, disp))
    C = SC2_C_FACTOR * max(r_p)
    ok, worst, loose = True, 0.0, 0
    for b, (first, it64, rounds, last, pins, disp) in enumerate(runs):
        if first is not None:
            ok &= first[0] <= SC2_DISP + C * first[1]
        if int(it_k[b]) == it64 and pins and disp <= SC2_DISP + C * last:
            worst = max(worst, disp)
            continue
        free = not pins or any(
            rounds[i][0] <= SC2_EPS + C * rounds[i - 1][3]
            for i in range(1, len(rounds)))
        log(f"  K15 problem {b}: {int(it_k[b])} rounds (plain "
            f"{int(it_p[b])}, f64 {it64}), {disp:.3e} m from the f64 pose; "
            f"the f64 run's rounds (least margin to the threshold, inliers, "
            f"C times the reach, pins a pose): "
            + "; ".join(f"{m:.2e} m, {n}, {C * r:.2e} m, {p}"
                        for m, n, _, r, p, _ in rounds))
        loose += 1
        ok &= free
    qcp = cfg.qcp_kabsch
    log(f"  K15: iterations {it_k.tolist()} (plain {it_p.tolist()}); "
        f"against the f64 rounds, largest ratio to the reach (2^-24 * lever "
        f"* E / gap, the moments' rounding"
        + (", plus the QCP solve's own, `_qcp_reach`" if qcp else "")
        + f") of one round {max(r_k):.3e}, the plain version's of one round "
        f"or a whole run {max(r_p):.3e} (C = {C:.3e})"
        + (f"; to the moments' reach alone: one round {max(o_k):.3e}, the "
           f"plain version's {max(o_p):.3e}" if qcp else "") + "; "
        f"{loose} problems whose rounds' sets pin no pose or whose inlier "
        f"tests f32 rounding can flip (above), the others within "
        f"{worst:.3e} m of the f64 run")
    return ok, worst


def _solve_flops(cfg):
    """One pose solve's flops: QCP ~600, the 8-sweep Jacobi JACOBI_FLOPS."""
    return 600 if cfg.qcp_kabsch else JACOBI_FLOPS


def _irls_cost(cfg, trans, best, src, tgt, valid):
    """K15's (K24's) bound: per round of each problem, two passes over its
    valid rows (45 flops a row) and the pose solve, for the rounds the
    plain version runs; bytes: the points and flags once, the start and
    final poses."""
    from eyoc_tpu_torch.registration.sc2pcr import sc2_irls_plain
    _, it = sc2_irls_plain(cfg, trans, best, src, tgt, valid)
    it = it.double()
    ops = float((it * (90.0 * valid.sum(1).double()
                       + _solve_flops(cfg))).sum())
    B, n = valid.shape
    return B * n * 25 + B * (64 + 4) + B * 68, ops, "f32"


def _sc2_valid(name, args):
    """The valid rows [B, N] among a K13, K14 or K15 call's arguments."""
    return args[1] if name == "sc2_nms" else args[-1]


def check_sc2_kernels(label, calls, suffix="", which=SC2_KERNELS):
    """K13, K14 and K15 (K23 and K24 where the calls' config has
    qcp_kabsch=False), those of `which`, each against its plain version on
    `calls` ({wrapper name: [(args, kwargs)]}); each also gives the same
    bits twice, and its device kernels a call and host cost are read.
    Returns {kernels-line name + suffix: row}."""
    from eyoc_tpu_torch.registration import sc2pcr
    out = {}
    cfg = calls["sc2_seed_transforms"][0][0][0]
    jac = not cfg.qcp_kabsch
    k14, k15 = ("K23", "K24") if jac else ("K14", "K15")
    tail = "_jacobi" if jac else ""
    for name, fn, plain, cost, close, what in (
            ("sc2_nms", sc2pcr.sc2_nms, sc2pcr.sc2_nms_plain, _nms_cost,
             _nms_close, "K13 sc2_nms"),
            ("sc2_seed_transforms", sc2pcr.sc2_seed_transforms,
             sc2pcr.seed_transforms_batched_plain, _seed_cost,
             _seed_close,
             f"{k14} sc2_seed_transforms{tail}"),
            ("sc2_irls", sc2pcr.sc2_irls, sc2pcr.sc2_irls_plain, _irls_cost,
             _irls_close,
             f"{k15} sc2_irls{tail}" + (
                 f", refine_unroll {cfg.refine_unroll}"
                 if cfg.refine_unroll else ""))):
        if name not in which:
            continue
        cl = calls[name]
        a, k = cl[0]
        B, n = _sc2_valid(name, a).shape
        tag = f"{what} ({label}, B = {B}, N = {n})"
        row = out[name + suffix] = check_calls(tag, cl, fn, plain, cost,
                                               close)
        same_bits_twice(tag, fn, cl)
        # K13: flags and ranks; K14: the compaction, the consensus of the
        # heads (and their QCP solves), the fitness (its argmax by each
        # problem's last block); K15: one
        # K23: the heads' Jacobi solves in a launch of their own
        expected = {"sc2_nms": 2, "sc2_seed_transforms": 4 if jac else 3,
                    "sc2_irls": 1}[name]
        kernels_per_call(tag, lambda: fn(*a, **k), reps=3,
                         expected=expected)
        launch_path(tag, fn, cl, label, 20)
        if name == "sc2_irls":
            rounds = fn(*a, **k)[1]
            most = int(rounds.max())
            dev = row["device_ms"]
            log(f"{tag}: rounds {rounds.tolist()}; device time a round of "
                f"the slowest problem "
                + ("not measured" if dev is None else
                   f"{dev / most * 1e3:.2f} us ({dev:.4f} ms / {most})"))
    return out


def sc2_no_sync(what, src, tgt, valid, cfg):
    """`sc2_pcr_batched` on B problems with no host sync (sync debug mode
    "error")."""
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import sc2_pcr_batched
    sc2_pcr_batched(src, tgt, valid, cfg)        # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trans, fit = sc2_pcr_batched(src, tgt, valid, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(trans).all()):
        raise AssertionError(f"sc2_pcr_batched ({what}): non-finite poses")
    log(f"sc2_pcr_batched ({what}, B = {valid.shape[0]}, N = "
        f"{valid.shape[1]}): no host sync (sync debug mode \"error\")")


# ------------------------------------------ phase 2, the Jacobi solve


# jacobi_pose.cuh's branch-free forms on the card (csrc/probes/
# jacobi_forms.cu): every float of [1, 2^128) through the root, every float
# of [1, 2^126] through the reciprocal, every float of [1, 2] through the
# reciprocal root (c's), JACOBI_PAIRS random quotient pairs
# and every exponent boundary pair; JACOBI_SETS random weighted sets, as
# many 3-point sets and the special Horn matrices through both solves
JACOBI_PAIRS = 1 << 28
JACOBI_SETS = 1 << 18
# sha1 digests (16 hex digits) of the outputs of the Jacobi solve's other
# users (`jacobi_digests`) made by their parent design (the IEEE solve
# alone, before the branch-free forms) on the card and toolchain of
# K23_DIGEST_KEY (profile_k24.py prints them): they must keep those bits
JACOBI_DIGESTS = {"K16": "3526915a8dee204a", "K18 polish": "9d502fda2806c4a7",
                  "icp_solve": "64ae6426bc861e43"}


def _forms(symbol, argtypes):
    from eyoc_tpu_torch.utils import kernels
    return kernels.load("probes/jacobi_forms", argtypes,
                        symbol=f"jacobi_forms_{symbol}")


def horn_test_sets(gen, n):
    """[m, 15] f32 (H, cA, cB) on the card: n random weighted sets of 12
    rows (a turn of up to ~0.5 rad, 0.2 m of noise), n 3-point sets of
    their first rows (K16's), and the special Horn matrices: H = 0, diagonal
    ones, repeated eigenvalues, a_pq overflowing tau^2, an entry below the
    quotient's range (the rerun)."""
    import torch
    a = torch.rand((n, 12, 3), generator=gen) * 40 - 20
    ang = torch.randn((n, 1, 3), generator=gen) * 0.5
    b = a + torch.cross(ang.expand_as(a), a, dim=-1) \
        + torch.randn((n, 12, 3), generator=gen) * 0.2
    w = torch.rand((n, 12), generator=gen)
    out = []
    for aa, bb, ww in ((a, b, w), (a[:, :3], b[:, :3],
                                   torch.ones((n, 3)))):
        s = ww.sum(1, keepdim=True)
        cA = (aa * ww[..., None]).sum(1) / s
        cB = (bb * ww[..., None]).sum(1) / s
        H = torch.einsum("nki,nkj->nij", (aa - cA[:, None]) * ww[..., None],
                         bb - cB[:, None])
        out.append(torch.cat([H.reshape(n, 9), cA, cB], 1))
    eye = torch.eye(3)
    special = [torch.zeros(3, 3), torch.diag(torch.tensor([3.0, 2.0, 1.0])),
               torch.diag(torch.tensor([1.0, -2.0, 0.5])), eye,
               torch.diag(torch.tensor([1.0, 1.0, 0.0])), -eye,
               torch.diag(torch.tensor([2.0, 2.0, -1.0])),
               torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.5, 1e-25],
                             [0.0, 0.0, 0.2]]),
               torch.tensor([[1.0, 1e-25, 0.0], [0.0, -0.5, 0.0],
                             [0.0, 0.0, 0.2]]),
               torch.tensor([[1.0, 1e-35, 0.0], [0.0, 0.5, 0.0],
                             [0.0, 0.0, 0.2]])]
    Hs = torch.stack(special).reshape(-1, 9)
    out.append(torch.cat([Hs, torch.zeros(len(special), 3),
                          torch.ones(len(special), 3)], 1))
    return torch.cat(out).float().cuda().contiguous()


def jacobi_reruns(source):
    """The Jacobi solves of a library ("ransac", "sc2_refine",
    "probes/jacobi_forms") that left the branch-free forms' range and ran
    again on the IEEE forms, since it was loaded."""
    import ctypes
    from eyoc_tpu_torch.utils import kernels
    fn = kernels.load(source, (ctypes.c_void_p,), symbol={
        "ransac": "ransac_jacobi_reruns",
        "sc2_refine": "sc2_refine_jacobi_reruns",
        "probes/jacobi_forms": "jacobi_forms_reruns"}[source])
    n = ctypes.c_ulonglong(0)
    kernels.check_error("jacobi_reruns", fn(ctypes.byref(n)))
    return n.value


_reruns_seen = {}


def log_reruns(what):
    """Logs the Jacobi solves of K16-K18 (ransac) and K23 / K24
    (sc2_refine) that took the IEEE rerun since the last call."""
    parts = []
    for src, who in (("ransac", "K16-K18"), ("sc2_refine", "K23 / K24")):
        n = jacobi_reruns(src)
        parts.append(f"{who} {n - _reruns_seen.get(src, 0)}")
        _reruns_seen[src] = n
    log(f"Jacobi solves that took the IEEE rerun ({what}): "
        + ", ".join(parts))


def check_jacobi_forms():
    """jacobi_pose.cuh's branch-free root, reciprocal and quotient against
    __fsqrt_rn / __fdiv_rn on the card, and jacobi_pose against
    jacobi_pose_ieee on horn_test_sets: each must give the same bits (every
    mismatch fails the run); logs the counts and the solves that took the
    rerun."""
    import ctypes

    import torch
    from eyoc_tpu_torch.utils import kernels
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    sweep = _forms("sweep", (I, U, U, P, P))
    quotients = _forms("quotients", (ctypes.c_ulonglong, U, I, P, P))
    solves = _forms("solves", (P, I, P, P, P))
    stream = kernels.stream_handle(0)
    rows = {}
    t0 = time.perf_counter()
    for name, call in (
            ("roots of [1, 2^128)", lambda o: sweep(0, 0x3F800000,
                                                    0x40000000, o, stream)),
            ("reciprocals of [1, 2^126]",
             lambda o: sweep(1, 0x3F800000, 0x3F000001, o, stream)),
            ("reciprocal roots of [1, 2]",
             lambda o: sweep(2, 0x3F800000, 0x800001, o, stream)),
            (f"quotients, {JACOBI_PAIRS} random pairs and every exponent "
             "boundary pair", lambda o: quotients(23, JACOBI_PAIRS, 1, o,
                                                  stream))):
        out = torch.zeros(3, dtype=torch.int64, device="cuda")
        kernels.check_error("jacobi_forms", call(out.data_ptr()))
        bad, seen, skipped = out.tolist()
        rows[name] = (bad, seen, skipped)
        if bad:
            raise AssertionError(f"jacobi_pose's branch-free {name}: {bad} "
                                 f"of {seen} differ from the IEEE "
                                 "intrinsic's bits")
    sets = horn_test_sets(torch.Generator().manual_seed(24), JACOBI_SETS)
    n = sets.shape[0]
    fast = torch.empty((n, 16), device="cuda")
    ieee = torch.empty((n, 16), device="cuda")
    before = jacobi_reruns("probes/jacobi_forms")
    kernels.check_error("jacobi_forms_solves", solves(
        sets.data_ptr(), n, fast.data_ptr(), ieee.data_ptr(), stream))
    differ = int((fast.view(torch.int32) != ieee.view(torch.int32))
                 .any(1).sum())
    reruns = jacobi_reruns("probes/jacobi_forms") - before
    if differ:
        raise AssertionError(f"jacobi_pose: {differ} of {n} solves differ "
                             "from jacobi_pose_ieee's bits")
    log("jacobi_pose.cuh's branch-free forms against the IEEE intrinsics on "
        "the card, mismatches (of checked; out of range, not compared): "
        + "; ".join(f"{k} {b} ({s}; {o})" for k, (b, s, o) in rows.items())
        + f"; jacobi_pose against jacobi_pose_ieee: {differ} of {n} solves "
        f"differ ({JACOBI_SETS} weighted sets, as many 3-point sets, "
        f"{n - 2 * JACOBI_SETS} special Horn matrices), {reruns} took the "
        f"rerun; {time.perf_counter() - t0:.1f} s")


def jacobi_user_calls():
    """{name: (fn, args)}: the Jacobi solve's users in csrc/ransac.cu at
    fixed inputs (generators of their own): K16's two-stage entry on an N
    = 5000 problem at 30% inliers with RANSAC's draws, K18's polish from
    its poses and K17's best, icp_solve on a 32768-row problem (every row
    its own match)."""
    import torch
    from eyoc_tpu_torch.registration import icp, ransac
    cfg = ransac.RansacConfig()
    src, tgt, valid, _ = correspondences(torch.Generator().manual_seed(31))
    draws = ransac.ransac_draws(cfg, "cuda",
                                torch.Generator(device="cuda").manual_seed(5))
    thr, lo = cfg.distance_threshold, cfg.edge_length_ratio
    k16 = (src, tgt, valid, *draws, thr, lo, cfg.full_verify_top)
    trans, coarse = ransac.ransac_hypotheses_topk(*k16)[:2]
    _, best = ransac.ransac_verify(trans, coarse, None, src, tgt, valid, thr)
    s, t, _, _ = correspondences(torch.Generator().manual_seed(32), n=32768)
    mask = torch.ones(32768, dtype=torch.bool, device="cuda")
    nn = torch.arange(32768, dtype=torch.int32, device="cuda")
    d2 = ((s - t) ** 2).sum(1)
    return {"K16": (ransac.ransac_hypotheses_topk, k16),
            "K18 polish": (ransac.ransac_polish, (trans, best, src, tgt,
                                                  valid, thr,
                                                  cfg.polish_iters)),
            "icp_solve": (icp.icp_solve, (s, mask, t, nn, d2, 0.2 * 0.2))}


def jacobi_digests(calls=None):
    """{name: sha1 digest} of the outputs of `jacobi_user_calls`."""
    calls = calls or jacobi_user_calls()
    return {k: sc2_digest(fn(*args)) for k, (fn, args) in calls.items()}


def check_jacobi_digests():
    """jacobi_digests against JACOBI_DIGESTS (the parent design's), where
    this card and toolchain are the ones they were made on; elsewhere they
    are logged only."""
    got = jacobi_digests()
    key = k23_digest_key()
    if key != K23_DIGEST_KEY or not JACOBI_DIGESTS:
        log(f"Jacobi users' digests: {got} (none recorded for {key})")
        return
    differ = {k: v for k, v in got.items() if v != JACOBI_DIGESTS.get(k)}
    if differ:
        raise AssertionError(f"the Jacobi solve's users changed their bits: "
                             f"{differ}, the IEEE solve gave "
                             f"{JACOBI_DIGESTS} on {key}")
    log(f"Jacobi users' digests: {got}, the IEEE solve's bits")


# ------------------------------------------------- phase 2, RANSAC and ICP


# the two-stage route's kernels (K16's entry `ransac_hypotheses_topk` is
# the kernels line's `ransac_hypotheses` row)
RANSAC_KERNELS = ("ransac_hypotheses_topk", "ransac_verify",
                  "ransac_polish")
# a count test may come out otherwise than under the f64 recount of the
# kernel's own pose only within RANSAC_EPS of the threshold: the f32 warp
# rounds at ~2^-24 * 3 * |x|, 1e-5 m at 50 m
RANSAC_EPS = 1e-4                    # m
# K16's poses, on the triplets whose Horn gap is at least SC2_GAP of the
# largest eigenvalue: each triplet point moves from the f64 solve by at most
# RANSAC_DISP + RANSAC_ROT / gap * lever (lever its distance from the
# origin; RANSAC_ROT / gap the f32 Jacobi's rotation reach, 2^-24 * 34)
RANSAC_DISP = 1e-4                   # m
RANSAC_ROT = 2e-6
RANSAC_SLICE = 65536                 # K16's poses and counts held on these
JACOBI_FLOPS = 4300                  # one 4x4 Jacobi solve (48 rotations)
# the poses of K18 (polish, ICP's solve) and of ICP's runs
POLISH_TOL = 1e-4                    # m, a valid row's displacement
ICP_TOL = 5e-3                       # m, kernel against plain ICP
ICP_N = 32768                        # icp_refine_numpy's cap


def _kabsch64(a, b, w):
    """The weighted Kabsch optimum in f64 by SVD with the determinant
    correction: a, b [..., n, 3], w [..., n] -> T [..., 4, 4]."""
    import torch
    from eyoc_tpu_torch.geometry.se3 import integrate_trans
    a, b, w = a.double(), b.double(), w.double()
    ws = w.sum(-1, keepdim=True) + 1e-6
    cA = (a * w[..., None]).sum(-2) / ws
    cB = (b * w[..., None]).sum(-2) / ws
    H = torch.einsum("...ni,...nj->...ij", (a - cA[..., None, :])
                     * w[..., None], b - cB[..., None, :])
    # the batched 3x3 decompositions on the host (cuSOLVER refuses batches
    # of this many)
    U, _, Vh = (x.to(a.device) for x in torch.linalg.svd(H.cpu()))
    d = torch.sign(torch.linalg.det((Vh.transpose(-1, -2)
                                     @ U.transpose(-1, -2)).cpu())
                   ).to(a.device)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    R = Vh.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    return integrate_trans(R, cB - torch.einsum("...ij,...j->...i", R, cA))


def _horn_gap64(a, b):
    """f64 eigen gap of each set's Horn matrix (unit weights) over its
    largest eigenvalue: a, b [..., n, 3]."""
    import torch
    from eyoc_tpu_torch.geometry.svd3 import horn_profile_matrix
    a, b = a.double(), b.double()
    am = a - a.mean(-2, keepdim=True)
    bm = b - b.mean(-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", am, bm)
    H = H / H.abs().amax((-1, -2), keepdim=True).clamp(min=1e-12)
    ev = torch.linalg.eigvalsh(horn_profile_matrix(H).cpu()).to(a.device)
    return (ev[..., 3] - ev[..., 2]) / ev.abs().amax(-1).clamp(min=1e-30)


def _count_band(T, s64, t64, ok, thr, other=None):
    """(f64 count under each pose T [H, 4, 4] of the rows `ok` within thr,
    rows within RANSAC_EPS of it, rows that the displacement to the poses
    `other` moves within RANSAC_EPS of it), chunked."""
    import torch
    cnt, band, slack = [], [], []
    for i in range(0, T.shape[0], 1024):
        d = _pose_dists(T[i:i + 1024], s64, t64)
        near = (d - thr).abs()
        cnt.append(((d < thr) & ok[None]).sum(1))
        band.append(((near <= RANSAC_EPS) & ok[None]).sum(1))
        if other is not None:
            D = (T[i:i + 1024] - other[i:i + 1024]).double()
            move = (torch.einsum("sij,nj->sni", D[:, :3, :3], s64)
                    + D[:, None, :3, 3]).norm(dim=-1)
            slack.append(((near <= RANSAC_EPS + move) & ok[None]).sum(1))
    return (torch.cat(cnt).double(), torch.cat(band).double(),
            torch.cat(slack).double() if other is not None else None)


def _pose_reach(T, a, pin, reach, T64):
    """(each triplet point's largest move from the f64 Kabsch T64 under the
    poses T, held: every pinned one within `reach`)."""
    import torch
    D = T.double() - T64
    d = (torch.einsum("hij,hnj->hni", D[:, :3, :3], a.double())
         + D[:, None, :3, 3]).norm(dim=-1).amax(-1)
    return d, bool((d <= reach)[pin].all())


def _triplets64(src, tgt, valid, u_tri):
    """(triplet rows a [h, 3, 3], Horn gap, pinned, the reach RANSAC_DISP +
    RANSAC_ROT / gap * lever, the f64 SVD Kabsch) of the hypotheses u_tri
    [h, 3]."""
    import torch
    from eyoc_tpu_torch.registration.ransac import _prefix_rows
    tri = _prefix_rows(u_tri, valid.sum().clamp(min=1), src.shape[0])
    a, b = src[tri], tgt[tri]
    gap = _horn_gap64(a, b)
    T64 = _kabsch64(a, b, torch.ones(a.shape[:-1], device=a.device))
    lever = a.double().norm(dim=-1).amax(-1)
    reach = RANSAC_DISP + RANSAC_ROT / gap.clamp(min=1e-30) * lever
    return a, gap, gap >= SC2_GAP, reach, T64


def _hyp_close(got, want, src, tgt, valid, u_tri, u_sub, thr, lo, k):
    """K16's two-stage entry against its plain version on the same draws.
    coarse: the edge flags bit-equal on every hypothesis, and the same bits
    as the single-stage entry's (whose poses are the same solve); on the
    first RANSAC_SLICE, each single-stage pose held to the f64 Kabsch of
    its triplet where the triplet pins one (the others counted), and each
    coarse count equal to the f64 recount under that pose but for tests
    within RANSAC_EPS of the threshold, and to the plain version's but for
    tests that the two poses move across it. keep: bit-equal to `topk` of
    the kernel's own coarse, the kept counts its coarse there. The kept
    poses: the single-stage entry's rows keep bit for bit, and each held to
    the f64 Kabsch where its triplet pins one."""
    import torch
    from eyoc_tpu_torch.registration import ransac
    (kept_t, kept_c, keep, coarse_k), (_, _, _, coarse_p) = got, want
    if not torch.equal(coarse_k >= 0, coarse_p >= 0):
        log("  K16: edge flags differ from the plain version's")
        return False, float("inf")
    h = min(RANSAC_SLICE, coarse_k.shape[0])
    trans_1, coarse_1 = ransac.ransac_hypotheses(src, tgt, valid, u_tri,
                                                 u_sub, thr, lo)
    trans_p = ransac.ransac_hypotheses_plain(src, tgt, valid, u_tri[:h],
                                             u_sub, thr, lo)[0]
    single = bool(torch.equal(coarse_k, coarse_1)) and bool(torch.equal(
        kept_t, trans_1[keep.long()]))
    top = bool(torch.equal(keep.long(), ransac.topk(coarse_k, k)[1])) and \
        bool(torch.equal(kept_c, coarse_k[keep.long()]))
    a, gap, pin, reach, T64 = _triplets64(src, tgt, valid, u_tri[:h])
    d_k, held = _pose_reach(trans_1[:h], a, pin, reach, T64)
    d_p, _ = _pose_reach(trans_p[:h], a, pin, reach, T64)
    ratio_k = float(((d_k - RANSAC_DISP) / (reach - RANSAC_DISP))[pin].max())
    ratio_p = float(((d_p - RANSAC_DISP) / (reach - RANSAC_DISP))[pin].max())
    ka, _, kpin, kreach, kT64 = _triplets64(src, tgt, valid,
                                            u_tri[keep.long()])
    d_kept, kept_held = _pose_reach(kept_t, ka, kpin, kreach, kT64)
    sub = ransac._prefix_rows(u_sub, valid.sum().clamp(min=1), src.shape[0])
    s64, t64 = src[sub].double(), tgt[sub].double()
    ones = torch.ones(sub.shape[0], dtype=torch.bool, device=src.device)
    edge = coarse_k[:h] >= 0
    cnt, band, slack = _count_band(trans_1[:h], s64, t64, ones, thr,
                                   trans_p[:h])
    ck, cp = coarse_k[:h].double(), coarse_p[:h].double()
    own = ((ck - cnt).abs() <= band)[edge]
    agree = ((ck - cp).abs() <= slack)[edge]
    log(f"  K16: edge flags bit-equal ({int((coarse_k >= 0).sum())} of "
        f"{coarse_k.numel()} pass); coarse the single-stage entry's bits "
        f"and the kept poses its rows: {'yes' if single else 'NO'}; keep "
        f"bit-equal to topk of the kernel's coarse: {'yes' if top else 'NO'}"
        f" (counts {float(kept_c.max()):g} down to {float(kept_c.min()):g})"
        f"; on the first {h}: {int(pin.sum())} triplets pin a pose (Horn gap "
        f">= {SC2_GAP}), the kernel's points within "
        f"{float(d_k[pin].max()):.3e} m of the f64 Kabsch, largest ratio to "
        f"the reach {RANSAC_ROT} / gap * lever {ratio_k:.3f} (plain "
        f"{ratio_p:.3f}; held to {RANSAC_DISP} m + 1x it: "
        f"{'yes' if held else 'NO'}); {int((~pin).sum())} triplets pin none "
        f"(repeated or collinear points: kernel within "
        f"{float(d_k[~pin].max()) if bool((~pin).any()) else 0.0:.3e} m); "
        f"the {keep.numel()} kept poses: {int(kpin.sum())} pinned, within "
        f"{float(d_kept[kpin].max()) if bool(kpin.any()) else 0.0:.3e} m "
        f"(held: {'yes' if kept_held else 'NO'}); coarse counts: "
        f"{int((ck != cnt)[edge].sum())} differ from the f64 recount of the "
        f"kernel's pose ({int((band > 0)[edge].sum())} with a test within "
        f"{RANSAC_EPS} m of the threshold), {int((ck != cp)[edge].sum())} "
        "from the plain version's")
    ok = single and top and held and kept_held and bool(own.all()) and \
        bool(agree.all())
    err = max(float(d_k[pin].max()),
              float(d_kept[kpin].max()) if bool(kpin.any()) else 0.0)
    del trans_1, trans_p
    torch.cuda.empty_cache()
    return ok, err


def _hyp_cost(src, tgt, valid, u_tri, u_sub, thr, lo, k):
    """K16's bound, recounted from what these inputs need: the edge check
    (~60 flops) for every hypothesis; a Jacobi solve for each survivor and
    each kept failing hypothesis; 27 flops a subset row for each survivor;
    bytes: the draws and the points once, coarse [H] and the k kept rows
    written. The single-stage bound (a solve for every hypothesis, the
    [H, 4, 4] poses written) is logged beside it."""
    from eyoc_tpu_torch.registration.ransac import (edge_ok_plain,
                                                    sample_triplets_plain)
    H, S = u_tri.shape[0], u_sub.shape[0]
    s3, t3 = sample_triplets_plain(u_tri, src, tgt,
                                   valid.sum().clamp(min=1))
    passed = float(edge_ok_plain(s3, t3, lo).sum())
    del s3, t3
    nbytes = H * 12 + S * 4 + src.shape[0] * 25 + H * 4 + k * 72
    ops = H * 60.0 + (passed + max(k - passed, 0)) * JACOBI_FLOPS \
        + passed * S * 27.0
    old = bound_ms(H * 12 + S * 4 + src.shape[0] * 25 + H * 68,
                   H * (JACOBI_FLOPS + 60.0) + passed * S * 27.0, "f32")
    new = bound_ms(nbytes, ops, "f32")
    log(f"  K16 bound: {new[0]:.4f} ms ({new[1]}; {passed:.0f} of {H} "
        f"survive the edge check: {ops / 1e9:.3f} GFLOP), the kernels line's;"
        f" a solve for every hypothesis and the [H, 4, 4] poses written "
        f"(the single-stage count): {old[0]:.4f} ms ({old[1]})")
    return nbytes, ops, "f32"


def _verify_close(got, want, trans, coarse, keep, src, tgt, valid, thr):
    """K17 against its plain version on the same kept set: each count equal
    to the f64 recount of the same pose but for tests within RANSAC_EPS of
    the threshold (both sides, so the two differ at most by their bands);
    -1 where the edge check failed; best the first argmax of the kernel's
    counts, and within the bands of the plain version's largest."""
    import torch
    (ck, bk), (cp, bp) = got, want
    v = valid
    s64, t64 = src[v].double(), tgt[v].double()
    ok_rows = torch.ones(s64.shape[0], dtype=torch.bool, device=src.device)
    rows = _kept_rows(coarse, keep)
    cnt, band, _ = _count_band(trans[rows], s64, t64, ok_rows, thr)
    edge = coarse[rows] >= 0
    ckd, cpd = ck.double(), cp.double()
    own = torch.where(edge, (ckd - cnt).abs() <= band, ckd == -1)
    agree = (ckd - cpd).abs() <= 2 * band
    first = int(bk) == int(rows[int(torch.argmax(ck))])
    j = int(torch.argmax(ck))
    top = bool(cpd[j] + 2 * band[j] >= cpd.max())
    log(f"  K17: {int((ckd != cpd).sum())} of {ck.numel()} counts differ "
        f"from the plain version's, {int((ckd != cnt)[edge].sum())} from the "
        f"f64 recount ({int((band > 0).sum())} with a test within "
        f"{RANSAC_EPS} m of the threshold); best row {int(bk)} (plain "
        f"{int(bp)}), count {float(ck.max()):g}")
    return (bool(own.all()) and bool(agree.all()) and first and top,
            float((ckd - cpd).abs().max()))


def _kept_rows(coarse, keep):
    """The rows of trans that K17 verifies: keep, or every one."""
    import torch
    return keep.long() if keep is not None else torch.arange(
        coarse.shape[0], device=coarse.device)


def _verify_cost(trans, coarse, keep, src, tgt, valid, thr):
    """K17's bound: 27 flops for each (kept hypothesis that passed the edge
    check, valid row); bytes: the kept poses, flags and indices, the points
    once, the counts."""
    rows = _kept_rows(coarse, keep)
    edge = float((coarse[rows] >= 0).sum())
    n = src.shape[0]
    Hk = rows.shape[0]
    return Hk * (64 + 4 + 4 + 4) + n * 25 + 4, 27.0 * edge * float(
        valid.sum()), "f32"


def _polish64(T, src, tgt, valid, thr, iters):
    """The polish (ransac.py:148-160) in f64 from pose T, SVD Kabsch: (T,
    the least margin of a valid row's inlier test to the threshold over the
    rounds)."""
    import torch
    a, b = src.double(), tgt.double()
    T = T.double()
    margin = float("inf")
    for _ in range(iters + 1):
        d = (a @ T[:3, :3].T + T[:3, 3] - b).norm(dim=-1)
        if bool(valid.any()):
            margin = min(margin, float((d - thr).abs()[valid].min()))
        w = ((d < thr) & valid).double()
        if _ == iters:
            break
        if float(w.sum()) >= 3:
            T = _kabsch64(a[None], b[None], w[None])[0]
    return T, margin


def _polish_close(got, want, trans, best, src, tgt, valid, thr, iters):
    """K18 `ransac_polish` against the plain version and the f64 polish from
    the same start: a valid row moves at most POLISH_TOL from either pose,
    and the inlier count is the plain version's, where no round's inlier
    test lies within RANSAC_EPS of the threshold (logged otherwise)."""
    (T_k, i_k), (T_p, i_p) = got, want
    s64 = src[valid].double()
    T64, margin = _polish64(trans[int(best)], src, tgt, valid, thr, iters)
    d_p = float(_pose_disp(T_k[None], T_p[None], s64)[0])
    d_64 = float(_pose_disp(T_k[None], T64[None], s64)[0])
    clear = margin > RANSAC_EPS
    log(f"  K18 ransac_polish: {int(i_k)} inliers (plain {int(i_p)}), the "
        f"pose within {d_p:.3e} m of the plain version's and {d_64:.3e} m of "
        f"the f64 polish over the valid rows; least margin of an inlier test "
        f"{margin:.3e} m")
    ok = (not clear) or (d_p <= POLISH_TOL and d_64 <= POLISH_TOL
                         and int(i_k) == int(i_p))
    return ok, max(d_p, d_64)


def _polish_cost(trans, best, src, tgt, valid, thr, iters):
    """K18 polish's bound: per round two passes over the rows (~30 and ~25
    flops a valid row) and a solve, and the final count; bytes: the points
    and flags once, the start pose and the outputs."""
    n, nv = src.shape[0], float(valid.sum())
    return n * 25 + 64 + 68, iters * (55.0 * nv + JACOBI_FLOPS) + 30.0 * nv, \
        "f32"


def _icp_solve_close(got, want, src, mask, tgt, nn, d2, r2):
    """K18 `icp_solve` against the plain version and the f64 Kabsch of the
    same correspondences: a valid source row moves at most POLISH_TOL from
    either pose, and the warped source is the kernel's pose applied in f64
    within POLISH_TOL."""
    import torch
    (T_k, w_k), (T_p, _) = got, want
    w = (mask & (d2 < r2)).double()
    T64 = _kabsch64(src[None], tgt[nn.long()][None], w[None])[0]
    s64 = src[mask].double()
    d_p = float(_pose_disp(T_k[None], T_p[None], s64)[0])
    d_64 = float(_pose_disp(T_k[None], T64[None], s64)[0])
    warp = (src.double() @ T_k[:3, :3].double().T + T_k[:3, 3].double())
    d_w = float((w_k.double() - warp).norm(dim=-1).max())
    log(f"  K18 icp_solve: {int(w.sum())} correspondences; the pose within "
        f"{d_p:.3e} m of the plain version's, {d_64:.3e} m of the f64 "
        f"Kabsch; warped source within {d_w:.3e} m of its pose in f64")
    return max(d_p, d_64, d_w) <= POLISH_TOL, max(d_p, d_64)


def _icp_solve_cost(src, mask, tgt, nn, d2, r2):
    """K18 icp_solve's bound: two passes (~25 flops a correspondence), the
    solve and the warp (15 flops a row); bytes: the source, mask, nn, d2
    and matched targets read once, the pose and warped source written."""
    n = src.shape[0]
    return n * (12 + 1 + 4 + 4 + 12) + 64 + n * 12, \
        25.0 * float(mask.sum()) + JACOBI_FLOPS + 15.0 * n, "f32"


def _k2_icp_close(got, want, q, qm, r, rm):
    """K2 at ICP's shape against the f64 nearest neighbour: each valid
    query's d2 within K2_D2_RTOL (relative, + 1e-6 m^2) of the f64 distance
    to the reference it names, that reference the f64 nearest where the
    f64 gap to the second exceeds K2_GAP m^2; and the plain (Gram form)
    version's index the same where that gap exceeds 1e-2 m^2 (the Gram
    form rounds at 2^-24 |x|^2, ~2e-4 m^2 at 50 m)."""
    import torch
    (d_k, i_k), (_, i_p) = got, want
    r64 = r.double()
    big = torch.where(rm, 0.0, float("inf")).double()
    first, second, true_d = [], [], []
    for i in range(0, q.shape[0], 2048):
        d = torch.cdist(q[i:i + 2048].double(), r64) ** 2 + big[None]
        two = torch.topk(d, 2, largest=False).values
        first.append(two[:, 0])
        second.append(two[:, 1])
        true_d.append(d.gather(1, i_k[i:i + 2048].long()[:, None])[:, 0])
    first, second, true_d = map(torch.cat, (first, second, true_d))
    gap = second - first
    qv = qm
    d_ok = ((d_k.double() - true_d).abs()
            <= K2_D2_RTOL * true_d + 1e-6)[qv].all()
    clear = qv & (gap > K2_GAP)
    nearest = bool((true_d[clear] <= first[clear]).all())
    wide = qv & (gap > 1e-2)
    plain = bool(torch.equal(i_k[wide], i_p[wide]))
    err = float((d_k.double() - true_d)[qv].abs().max())
    log(f"  K2 at ICP's shape: {int(clear.sum())} of {int(qv.sum())} queries "
        f"with an f64 gap over {K2_GAP} m^2 name the f64 nearest; "
        f"{int(wide.sum())} with a gap over 1e-2 m^2 equal the plain "
        f"version's; max d2 err against f64 {err:.3e} m^2")
    return bool(d_ok) and nearest and plain, err


def check_ransac_kernels(gen, batch):
    """K16, K17, K18 (both entries) and K2 at ICP's shape, each against its
    plain version at the path's shapes (N = 5000 correspondences at 30%
    inliers, H = 1048576 hypotheses, a 512-row subset, the top 2048; ICP
    at 32768 x 32768 on `icp_pair(batch)`); each also gives the same bits twice, and its device
    kernels a call and host cost are read. Returns {kernels-line name:
    row}."""
    import torch
    from eyoc_tpu_torch.ops.knn import masked_argmin, masked_argmin_plain
    from eyoc_tpu_torch.registration import icp, ransac
    cfg = ransac.RansacConfig()
    src, tgt, valid, _ = correspondences(gen)
    draws = ransac.ransac_draws(cfg, "cuda",
                                torch.Generator(device="cuda").manual_seed(5))
    thr, lo = cfg.distance_threshold, cfg.edge_length_ratio
    k16 = (src, tgt, valid, *draws, thr, lo, cfg.full_verify_top)
    trans, coarse, _, _ = ransac.ransac_hypotheses_topk(*k16)
    # K17 over the kept set, as the two-stage route runs it
    k17 = (trans, coarse, None, src, tgt, valid, thr)
    _, best = ransac.ransac_verify(*k17)
    k18 = (trans, best, src, tgt, valid, thr, cfg.polish_iters)
    s, sm, t, tm = (torch.from_numpy(a).cuda()
                    for a in icp.icp_inputs(*icp_pair(batch)[:2]))
    d2, nn = masked_argmin(s, sm, t, tm)
    r2 = 0.2 * 0.2
    kicp = (s, sm, t, nn, d2, r2)
    out = {}
    for name, fn, plain, cost, close, args, nk, what, lib in (
            ("ransac_hypotheses", ransac.ransac_hypotheses_topk,
             ransac.ransac_hypotheses_topk_plain, _hyp_cost, _hyp_close, k16,
             6, "K16 ransac_hypotheses_topk (H = 1048576, subset 512, the "
             "top 2048, N = 5000)", "a triplet, an edge check, a Kabsch and "
             "a count a hypothesis, then a top k with its poses"),
            ("ransac_verify", ransac.ransac_verify,
             ransac.ransac_verify_plain, _verify_cost, _verify_close, k17, 1,
             "K17 ransac_verify (2048 x 5000)", "a count of the rows within "
             "a threshold under each of 2048 poses, then a first argmax"),
            ("ransac_polish", ransac.ransac_polish,
             ransac.ransac_polish_plain, _polish_cost, _polish_close, k18, 1,
             "K18 ransac_polish (N = 5000, 5 rounds)",
             "rounds of a weighted Kabsch on a changing inlier set"),
            ("icp_solve", icp.icp_solve, icp.icp_solve_plain,
             _icp_solve_cost, _icp_solve_close, kicp, 3,
             f"K18 icp_solve (N = {s.shape[0]})",
             "a gated weighted Kabsch and a warp"),
            ("masked_argmin_icp", masked_argmin, masked_argmin_plain,
             _argmin_cost, _k2_icp_close, (s, sm, t, tm), 1,
             f"K2 masked_argmin at ICP's shape ({s.shape[0]} x {t.shape[0]}"
             " x 3)", "`cdist` then `argmin` is two calls")):
        cl = [(args, {})]
        out[name] = check_calls(what, cl, fn, plain, cost, close)
        out[name]["library_ms"] = None
        log(f"  {what}: library: none: {lib}")
        same_bits_twice(what, fn, cl)
        kernels_per_call(what, lambda: fn(*args), reps=3, expected=nk)
        launch_path(what, fn, cl, "the path's shape", 20)
    del trans, coarse
    torch.cuda.empty_cache()
    return out


def icp_pair(batch):
    """(xyz0, xyz1, T_true): a KITTI-scale synthetic scan (cloud 0 of the
    one-pair batch `batch`, on the host) and the same scan under a known
    pose (2 deg of yaw, 1.27 m), float32."""
    from eyoc_tpu_torch.data.synthetic import rotation_about
    xyz0 = batch.xyz0[0, :int(batch.n0[0])].cpu().numpy()
    T = np.eye(4)
    T[:3, :3] = rotation_about(np.array([0.05, -0.02, 1.0]), np.radians(2.0))
    T[:3, 3] = [1.2, -0.4, 0.05]
    xyz1 = (xyz0.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(
        np.float32)
    return xyz0, xyz1, T


def ransac_stages(x, cfg, gen):
    """One RANSAC eval pair's registration split by stage (host clock
    around synchronized calls, ms): the subset, K2, K16 with its draws and
    the top 2048, K17, K18; as `eval.register_pair` runs them."""
    import torch
    from eyoc_tpu_torch import eval as teval
    from eyoc_tpu_torch.ops.knn import masked_argmin
    from eyoc_tpu_torch.registration import ransac
    rc = cfg.ransac_config
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    x0, f0, m0, x1, f1, m1 = x
    mark()
    sub = []
    for xk, fk, mk in ((x0, f0, m0), (x1, f1, m1)):
        z = teval.subset_noise(mk, gen)
        sel = teval.random_subset(z, cfg.eval_sample_points)
        sub += [xk[sel], fk[sel], mk[sel]]
    sx0, sf0, sm0, sx1, sf1, sm1 = sub
    mark()
    _, nn = masked_argmin(sf0, sm0, sf1, sm1)
    tgt = sx1[nn.long()]
    mark()
    u_tri, u_sub = ransac.ransac_draws(rc, "cuda", gen)
    trans, coarse, _, _ = ransac.ransac_hypotheses_topk(
        sx0, tgt, sm0, u_tri, u_sub, rc.distance_threshold,
        rc.edge_length_ratio, rc.full_verify_top)
    mark()
    _, best = ransac.ransac_verify(trans, coarse, None, sx0, tgt, sm0,
                                   rc.distance_threshold)
    mark()
    ransac.ransac_polish(trans, best, sx0, tgt, sm0, rc.distance_threshold,
                         rc.polish_iters)
    mark()
    return np.diff(marks) * 1e3


RANSAC_STAGES = ("subset", "K2 masked_argmin", "K16 ransac_hypotheses_topk "
                 "(with its draws and the top 2048)", "K17 ransac_verify",
                 "K18 ransac_polish")


def ransac_eval_phase(model, pairs, cfg, smi):
    """The eval path with RANSAC (`eval.test_pair(use_ransac=True)`) on the
    eval pairs: finite poses, exactly one K2, K16 (its two-stage entry),
    K17 and K18 polish launch a pair, no single-stage K16 and no SC2-PCR
    kernel (counts reset just before, read just after), `register_pair`
    with no host sync (sync debug mode "error"), its peak device memory
    below one [H, 4, 4] pose array, no sort over H elements in a profiled
    pair, the registration split by stage, and one pair with
    `downsample_single` 0.5. Returns the launch counts."""
    import dataclasses
    import torch
    from eyoc_tpu_torch import eval as teval
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.utils import kernels
    rcfg = dataclasses.replace(cfg, use_ransac=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = teval.embed_pair(model, pairs[0].to("cuda"), rcfg)
    teval.register_pair(*x, rcfg, generator=gen)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T_est = teval.register_pair(*x, rcfg, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("eval pair with RANSAC: register_pair runs with no host sync (sync "
        "debug mode \"error\")")
    H = rcfg.ransac_config.num_hypotheses
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    T_est = teval.register_pair(*x, rcfg, generator=gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"eval pair with RANSAC: register_pair peaks at {peak / 2 ** 20:.1f} "
        f"MiB above its inputs (an [H, 4, 4] f32 pose array alone is "
        f"{H * 64 / 2 ** 20:.1f} MiB)")
    if peak >= H * 64:
        raise AssertionError(f"register_pair with RANSAC peaks at {peak} "
                             "bytes: room for an [H, 4, 4] pose array")
    largest_sort(model, pairs[0].to("cuda"), rcfg, gen, H,
                 "RANSAC eval pair")
    torch.cuda.synchronize()
    kernels.reset_counts()
    pair_ms, n_ok = [], 0
    for batch in pairs:
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = teval.test_pair(model, batch, rcfg, generator=gen)
        torch.cuda.synchronize()
        pair_ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(out["T_est"]).all()):
            raise AssertionError(f"non-finite RANSAC T_est {out['T_est']}")
        ok, te, re = registration_success(out["T_est"], batch.T_gt[0])
        n_ok += int(ok)
        log(f"RANSAC pair: test_pair {pair_ms[-1]:.2f} ms, RTE "
            f"{float(te):.3f} m, RRE {float(re):.3f} deg")
    counts = dict(kernels.launches)
    log(json.dumps({"ransac_eval_launch_counts": counts}))
    for k in ("masked_argmin",) + RANSAC_KERNELS:
        if counts[k] != len(pairs):
            raise AssertionError(f"the RANSAC eval path launched {k} "
                                 f"{counts[k]} times for {len(pairs)} pairs")
    if counts["ransac_hypotheses"]:
        raise AssertionError("the RANSAC eval path launched K16's "
                             "single-stage entry")
    if any(counts[k] for k in SC2_KERNELS + ("sc2_power_iteration",
                                             "sc2_seed_topk")):
        raise AssertionError("the RANSAC eval path launched SC2-PCR kernels")
    stages = []
    for batch in pairs:
        x = teval.embed_pair(model, batch.to("cuda"), rcfg)
        stages.append(ransac_stages(x, rcfg, gen))
    mean = np.mean(stages, 0)
    log("RANSAC eval stages, ms a pair (mean of "
        f"{len(pairs)}, host clock around synchronized calls): "
        + ", ".join(f"{n} {v:.3f}" for n, v in zip(RANSAC_STAGES, mean))
        + f"; reg {float(mean.sum()):.3f}")
    ds = dataclasses.replace(rcfg, downsample_single=0.5)
    out = teval.test_pair(model, pairs[0].to("cuda"), ds, generator=gen)
    if not bool(torch.isfinite(out["T_est"]).all()):
        raise AssertionError("non-finite RANSAC T_est at downsample 0.5")
    log(f"RANSAC pair at downsample_single 0.5: RTE {float(out['rte']):.3f} "
        f"m, RRE {float(out['rre']):.3f} deg")
    log(f"RANSAC eval path: {len(pairs)} pairs, test_pair "
        f"{np.mean(pair_ms):.2f} ms a pair (host clock), RR of the untrained "
        f"net {n_ok}/{len(pairs)}, on {smi}")
    return counts


def ransac_known_answers(sanity, src, tgt, valid, T_true):
    """RANSAC (the default configuration, draws from a CUDA generator) on
    phase 4's three known-pose problems recovers each pose within phase 4's
    tolerances (RTE < 0.1 m, RRE < 1 deg)."""
    import torch
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.registration import ransac
    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, (inlier, nv) in enumerate(sanity):
        T, inl = ransac.ransac_registration(src[b], tgt[b], valid[b],
                                            generator=gen)
        _, te, re = registration_success(T, T_true[b])
        if not (float(te) < 0.1 and float(re) < 1.0):
            raise AssertionError(f"RANSAC missed a known pose ({inlier} "
                                 f"inliers, {nv} valid rows): RTE "
                                 f"{float(te)} m, RRE {float(re)} deg")
        log(f"RANSAC sanity, {inlier} inliers, {nv} of {N_CORR} rows valid: "
            f"RTE {float(te):.4f} m, RRE {float(re):.4f} deg, {int(inl)} "
            "inliers")


def icp_known_answer(batch):
    """ICP (`icp_refine_numpy`: 5 cm voxels, 32768 points, r 0.2 m, 100
    rounds) on a scan and the same scan under a known pose, from that pose
    perturbed by 0.1 m and 0.5 deg: RTE < 0.02 m and RRE < 0.1 deg; 101 K2
    and 100 `icp_solve` launches (counts reset just before, read just
    after) and no host sync in `icp_point_to_point`; the plain path's pose
    (Gram-form K2, plain Kabsch, 100 rounds) within ICP_TOL m of the
    kernels' over the valid rows. Returns the launch counts."""
    import torch
    from eyoc_tpu_torch.data.synthetic import rotation_about
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.registration import icp
    from eyoc_tpu_torch.utils import kernels
    xyz0, xyz1, T = icp_pair(batch)
    P = np.eye(4)
    P[:3, :3] = rotation_about(np.array([0.3, 1.0, 0.2]), np.radians(0.5))
    P[:3, 3] = np.array([0.06, -0.08, 0.0])            # 0.1 m
    init = P @ T
    arrays = icp.icp_inputs(xyz0, xyz1)
    s, sm, t, tm = (torch.from_numpy(a).cuda() for a in arrays)
    init_t = torch.from_numpy(init.astype(np.float32)).cuda()
    icp.icp_point_to_point(s, sm, t, tm, init_t, iterations=2)   # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    T_np = icp.icp_refine_numpy(xyz0, xyz1, init)
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)
    if counts["masked_argmin"] != 101 or counts["icp_solve"] != 100:
        raise AssertionError(f"ICP launched {counts['masked_argmin']} K2 and "
                             f"{counts['icp_solve']} icp_solve, not 101 and "
                             "100")
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        T_k, fit, rmse = icp.icp_point_to_point(s, sm, t, tm, init_t)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.array_equal(T_k.double().cpu().numpy(), T_np):
        raise AssertionError("icp_refine_numpy and icp_point_to_point differ")
    T_true = torch.from_numpy(T).float().cuda()
    _, te, re = registration_success(T_k, T_true)
    _, te0, re0 = registration_success(init_t, T_true)
    t0 = time.perf_counter()
    T_p, fit_p, _ = icp.icp_point_to_point_plain(s, sm, t, tm, init_t)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    gap = float(_pose_disp(T_k[None], T_p[None], s[sm].double())[0])
    log(f"ICP known answer: {int(sm.sum())} / {int(tm.sum())} points, from "
        f"RTE {float(te0):.3f} m, RRE {float(re0):.3f} deg to RTE "
        f"{float(te):.4f} m, RRE {float(re):.4f} deg, fitness "
        f"{float(fit):.4f} (plain {float(fit_p):.4f}), RMSE "
        f"{float(rmse):.4f} m; icp_refine_numpy {ms:.2f} ms, "
        f"icp_point_to_point {run_ms:.2f} ms with no host sync (sync debug "
        f"mode \"error\"), plain path {plain_ms:.2f} ms, its pose within "
        f"{gap:.3e} m of the kernels' over the valid rows; launches "
        f"{counts['masked_argmin']} K2, {counts['icp_solve']} icp_solve")
    if not (float(te) < 0.02 and float(re) < 0.1):
        raise AssertionError(f"ICP missed the known pose: RTE {float(te)} m, "
                             f"RRE {float(re)} deg")
    if gap > ICP_TOL:
        raise AssertionError(f"ICP's plain path ends {gap} m from the "
                             "kernels' pose")
    return counts


# ------------------------------------- phase 2, the valid step and the IN norm


# K19's pose against the same 20 rounds in f64 and against the plain
# version: a valid source row moves at most K19_TOL between two poses (the
# f32 rounds' reach at KITTI scale is ~1e-5 m: two sum orders, f32 warps
# compounding over 20 rounds)
K19_TOL = 1e-4                       # m
K19_ROUND_FLOPS = 70                 # a valid row a round: warp, weight,
                                     # 16 terms and their sums
K19_SOLVE_FLOPS = 250                # a round's solve (its 3 x 3 Schur
                                     # complement, ~90), sincos, the compose
# K20 against its plain version: bf16 outputs of f32 statistics summed in
# two orders, within K20_ULPS units in the last place of |want|, floored
# at 2^-8 of the call's largest |want| (near zero x g + off cancels, and
# the statistics' rounding is of the operands' size)
K20_ULPS = 1
# the IN norms of one forward, counted from the models' code: 2 a residual
# block, at 4 encoder and 3 decoder levels (ResUNetIN2C's top-level norms
# are BN, folded); every top-level norm of SimpleNetIN2 (4 encoder, 3
# decoder, conv1_tr's)
IN_SPECS = {"ResUNetIN2C": 14, "SimpleNetIN2": 8}
K19_BATCH_N = 9000                   # past one CTA's shared-memory rows
K19_OVER = 1000                      # rows past a cluster's shared memory


def _quad64(src, tgt, valid, iters=20):
    """`est_quad_linear_robust`'s rounds in f64 on the host over each
    problem's valid rows: [B, 4, 4] f64."""
    import torch
    from eyoc_tpu_torch.geometry import robust
    out = []
    f64 = torch.float64
    for b in range(valid.shape[0]):
        v = valid[b].cpu()
        p, q = src[b].cpu()[v].double(), tgt[b].cpu()[v].double()
        w = torch.ones(p.shape[0], dtype=f64)
        T, par = torch.eye(4, dtype=f64), 1.0
        for i in range(iters):
            if i > 0 and i % 5 == 0:
                par /= 2.0
            M, rhs = robust._normal_equations(p, q, w)
            x = torch.linalg.solve(M + 1e-6 * torch.eye(6, dtype=f64), rhs)
            Ti = robust._small_angle_trans(x)
            p = p @ Ti[:3, :3].T + Ti[:3, 3]
            w = par / ((p - q).norm(dim=1) + par)
            T = Ti @ T
        out.append(T)
    return torch.stack(out)


def _row_disp(Ta, Tb, src, valid):
    """[B] largest distance between a valid source row warped by Ta and by
    Tb (f64 on the host; 0 where no row is valid)."""
    out = []
    for b in range(valid.shape[0]):
        p = src[b].cpu()[valid[b].cpu()].double()
        A, B = Ta[b].cpu().double(), Tb[b].cpu().double()
        d = p @ (A[:3, :3] - B[:3, :3]).T + (A[:3, 3] - B[:3, 3])
        out.append(float(d.norm(dim=1).max()) if p.shape[0] else 0.0)
    return out


def _k19_close(got, want, src, tgt, valid):
    """K19 against the plain version and the f64 rounds: every valid row
    within K19_TOL of both poses; a problem with no valid row the
    identity."""
    import torch
    T64 = _quad64(src, tgt, valid)
    d_p = _row_disp(got, want, src, valid)
    d_64 = _row_disp(got, T64, src, valid)
    empty = ~valid.any(1)
    eye = torch.eye(4, device=got.device)
    ident = bool((got[empty] == eye).all())
    log(f"  K19: valid rows {valid.sum(1).tolist()}, a valid row within "
        f"{max(d_p):.3e} m of the plain version's pose and {max(d_64):.3e} m "
        f"of the f64 rounds'" + (", the identity where none is valid"
                                 if bool(empty.any()) else ""))
    return (max(d_p) <= K19_TOL and max(d_64) <= K19_TOL and ident,
            max(max(d_p), max(d_64)))


def _k19_cost(src, tgt, valid):
    """K19's bound: the points and flags read once, the poses written;
    20 rounds of K19_ROUND_FLOPS a valid row and a solve a problem."""
    nv = float(valid.sum())
    B = valid.shape[0]
    return (src.numel() * 4 * 2 + valid.numel() + B * 64,
            20 * (K19_ROUND_FLOPS * nv + K19_SOLVE_FLOPS * B), "f32")


def k19_problems(gen):
    """(the valid shape: B = 1, N_CORR correspondences at 30% inliers, every
    row valid; a batch of 3 problems of K19_BATCH_N rows with 0, 3 (inliers:
    they pin the pose) and K19_BATCH_N valid rows, 30% inliers)."""
    import torch
    src, tgt, valid, _ = correspondences(gen)
    one = (src[None].contiguous(), tgt[None].contiguous(),
           valid[None].contiguous())
    s, t, _, _ = correspondences(gen, n=K19_BATCH_N)
    s3, t3, _, _ = correspondences(gen, n=K19_BATCH_N, inlier=1.0)
    src_b = torch.stack([s, s3, s])
    tgt_b = torch.stack([t, t3, t])
    v = torch.zeros((3, K19_BATCH_N), dtype=torch.bool, device="cuda")
    v[1, torch.randperm(K19_BATCH_N, generator=gen)[:3].cuda()] = True
    v[2] = True
    return one, (src_b, tgt_b, v)


def k19_over_problem(gen):
    """One problem of K19_CLUSTER * K19_MAX_ROWS + K19_OVER rows at 30%
    inliers, every row valid: past the cluster's shared memory, its rows
    read from the global copy."""
    from eyoc_tpu_torch.geometry import robust
    n = robust.K19_CLUSTER * robust.K19_MAX_ROWS + K19_OVER
    src, tgt, valid, _ = correspondences(gen, n=n)
    return src[None].contiguous(), tgt[None].contiguous(), valid[None]


def check_k19(gen):
    """K19 at the valid step's shape (the kernels line's row) and on the
    batch of k19_problems (checked and logged): against the plain version
    and the f64 rounds, the same bits twice, one device kernel a call, its
    host cost."""
    from eyoc_tpu_torch.geometry import robust
    one, batch = k19_problems(gen)
    fn = robust.est_quad_linear_robust

    def plain_fn(src, tgt, valid):
        return robust.est_quad_linear_robust_plain(src, tgt, mask=valid)
    what = (f"K19 est_quad_linear_robust (B = 1, N = {N_CORR}, 20 rounds, "
            f"a cluster of {robust.K19_CLUSTER} CTAs a problem)")
    cl = [(one, {})]
    row = check_calls(what, cl, fn, plain_fn, _k19_cost, _k19_close)
    row["library_ms"] = None
    log(f"  {what}: library: none: 20 dependent rounds of a weighted 6 x 6 "
        "solve")
    same_bits_twice(what, fn, cl)
    kernels_per_call(what, lambda: fn(*one), reps=3, expected=1)
    launch_path(what, fn, cl, "the valid step's shape", 20)
    what_b = (f"K19 est_quad_linear_robust, a batch of 3 problems of "
              f"{K19_BATCH_N} rows (0, 3, {K19_BATCH_N} valid)")
    clb = [(batch, {})]
    check_calls(what_b, clb, fn, plain_fn, _k19_cost, _k19_close)
    same_bits_twice(what_b, fn, clb)
    over = k19_over_problem(gen)
    what_o = (f"K19 est_quad_linear_robust, one problem of "
              f"{over[2].shape[1]} rows (past {robust.K19_CLUSTER} x "
              f"{robust.K19_MAX_ROWS} rows of a cluster's shared memory)")
    clo = [(over, {})]
    check_calls(what_o, clo, fn, plain_fn, _k19_cost, _k19_close)
    same_bits_twice(what_o, fn, clo)
    return row


def _ulps(got, want):
    got, want = got.float(), want.float()
    if want.numel() == 0:
        return 0.0
    floor = max(float(want.abs().max()) * 2.0 ** -8, 2.0 ** -126)
    mag = want.abs().clamp(min=floor)
    return float(((got - want).abs() / (mag.log2().floor() - 7).exp2()).max())


def _k20_close(got, want, *args, skip=False, with_stats=False, **kw):
    """K20 against its plain version in bf16 ulps (`_ulps`), y and, with
    `skip`, the pre-ReLU output; with `with_stats` (the train forward) also
    its statistics (`_stats_close`) and, for a residual call, y within one
    ulp of the plain pre-residual output y0 plus one of y (`_sum_ulps`)."""
    if with_stats:
        (got, g_st), (want, w_st) = got, want
    pairs = list(zip(got, want)) if skip else [(got, want)]
    if with_stats and kw.get("residual") is not None:
        from eyoc_tpu_torch.sparse.norm import masked_instance_norm_plain
        _, y0 = masked_instance_norm_plain(*args, **dict(kw, skip=True,
                                                         residual=None))
        ulps = _sum_ulps(got, want, y0)
    else:
        ulps = max(_ulps(g, w) for g, w in pairs)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
    ok = ulps <= K20_ULPS
    if with_stats:
        ok = ok and _stats_close(g_st, w_st, *args[:3])
    return ok, err


def _sum_ulps(got, want, y0):
    """|got - want| of y = bf16(y0 + residual) in units of one bf16 ulp of
    y0 plus one of y (each floored as `_ulps`): a y0 one ulp apart moves
    the sum by its own ulp, which cancellation can make many of y's."""
    got, want, y0 = got.float(), want.float(), y0.float()
    if want.numel() == 0:
        return 0.0

    def ulp(v):
        floor = max(float(v.abs().max()) * 2.0 ** -8, 2.0 ** -126)
        return (v.abs().clamp(min=floor).log2().floor() - 7).exp2()
    return float(((got - want).abs() / (ulp(y0) + ulp(want))).max())


def _stats_close(got, want, x, mask, n_segments):
    """K20's statistics output [S, 3C] (mean, rstd, live) against the plain
    version's: the sums in two orders move mean by K20_STATS_REL of the
    segment's mean |x| and var by K20_STATS_REL of its mean x^2 (3 such
    for var_raw with the mean's share), rstd by half var's error times
    rstd^3 (plus the plain rsqrt's few ulps); live may differ only where
    var_raw is within that of 0."""
    S = n_segments
    M, C = x.shape
    m = mask.float().reshape(S, M // S, 1)
    xf = x.float().reshape(S, M // S, C)
    n = m.sum((1, 2)).clamp(min=1.0)[:, None]
    a1 = (xf.abs() * m).sum(1) / n
    a2 = (xf * xf * m).sum(1) / n
    g, w = got.reshape(S, 3, C), want.reshape(S, 3, C)
    dvar = 3 * K20_STATS_REL * a2
    ok_mean = ((g[:, 0] - w[:, 0]).abs() <= K20_STATS_REL * a1 + 1e-30)
    r = w[:, 1]
    ok_rstd = ((g[:, 1] - r).abs() <= r * (0.5 * dvar * r * r + 1e-6))
    var = 1.0 / (r * r) - 1e-5
    ok_live = (g[:, 2] == w[:, 2]) | (var.abs() <= dvar)
    ok = bool((ok_mean & ok_rstd & ok_live).all())
    if not ok:
        log(f"  K20 statistics: mean {int((~ok_mean).sum())}, rstd "
            f"{int((~ok_rstd).sum())}, live {int((~ok_live).sum())} of "
            f"{S * C} (cloud, channel) outside the bound")
    return ok


def _k20_cost(x, mask, n_segments, scale, bias, eps=1e-5, relu=False,
              residual=None, skip=False, with_stats=False):
    """K20's bound: x, the mask, scale and bias and the residual read once,
    y (and the pre-ReLU output, and the statistics) written once; the sums
    (3 flops an element) and the apply (2 to 4)."""
    e = x.element_size()
    nbytes = x.numel() * e * (2 + int(skip) + int(residual is not None)) \
        + mask.numel() + 2 * scale.numel() * 4 \
        + int(with_stats) * n_segments * 3 * scale.numel() * 4
    return nbytes, 7.0 * x.numel(), "f32"


def _k20_class(x, mask, n_segments, scale, bias, eps=1e-5, relu=False,
               residual=None, skip=False, with_stats=False):
    return (f"{x.shape[0]} x {x.shape[1]} "
            f"{_tail(relu, residual is not None, skip)}")


def _tail(relu: bool, residual: bool, skip: bool) -> str:
    return ("residual" if residual else "relu+skip" if skip
            else "relu" if relu else "plain")


# K21 against its plain version: dx in bf16 ulps (`_ulps`: f32
# coefficients of sums in two orders; dx = a ((dy0 - b) - xhat coef) can
# cancel, so two), dresidual bit-equal (it is dy0), dscale and dbias
# within K21_REL of the plain sums of absolute values (K7's tolerance)
K21_ULPS = 2
K21_REL = 1e-4
# K22 against its plain version: the same f32 operations, each rounded
# apart, then the same bf16 rounding: equal values
K22_ULPS = 0
K20_STATS_REL = 1e-4


def _k21_plain(x, mask, n_segments, scale, stats, dy, y=None, dpre=None,
               residual=False, counter=None):
    from eyoc_tpu_torch.sparse.norm import masked_norm_backward_plain
    return masked_norm_backward_plain(x, mask, n_segments, scale, stats, dy,
                                      y, dpre, residual)


def _k21_close(got, want, x, mask, n_segments, scale, stats, dy, y=None,
               dpre=None, residual=False, counter=None):
    import torch
    from eyoc_tpu_torch.sparse.norm import _grad_at_norm
    (dx, dres, ds, db), (wdx, wdres, wds, wdb) = got, want
    S = n_segments
    M, C = x.shape
    d = (_grad_at_norm(dy, y, dpre, x.dtype).abs()
         * mask.float()[:, None]).reshape(S, M // S, C)
    mean, rstd = stats.reshape(S, 3, C)[:, 0], stats.reshape(S, 3, C)[:, 1]
    xh = ((x.float().reshape(S, M // S, C) - mean[:, None])
          * rstd[:, None]).abs()
    size_db = d.sum((0, 1))
    size_ds = (d * xh).sum((0, 1))
    ok = _ulps(dx, wdx) <= K21_ULPS
    ok = ok and (dres is None) == (wdres is None) \
        and (dres is None or torch.equal(dres, wdres))
    ok = ok and bool(((ds - wds).abs() <= K21_REL * size_ds + 1e-6).all()) \
        and bool(((db - wdb).abs() <= K21_REL * size_db + 1e-6).all())
    err = max(float((dx.float() - wdx.float()).abs().max()),
              float((ds - wds).abs().max()), float((db - wdb).abs().max()))
    return ok, err


def _k21_cost(x, mask, n_segments, scale, stats, dy, y=None, dpre=None,
              residual=False, counter=None):
    """K21's bound: x, dy, y and dpre read once, dx and dresidual written
    once, the mask, scale, statistics and parameter grads; ~10 flops an
    element (the sums' 4, dx's 6)."""
    e = x.element_size()
    reads = 2 + int(y is not None) + int(dpre is not None)
    nbytes = x.numel() * e * (reads + 1 + int(residual)) + mask.numel() \
        + (stats.numel() + 3 * scale.numel()) * 4
    return nbytes, 10.0 * x.numel(), "f32"


def _k21_class(x, mask, n_segments, scale, stats, dy, y=None, dpre=None,
               residual=False, counter=None):
    return (f"{x.shape[0]} x {x.shape[1]}, {n_segments} segment(s), "
            f"{_tail(y is not None, residual, dpre is not None)}")


def _k22_close(got, want, x, mask, gof, relu=False, residual=None,
               skip=False):
    pairs = list(zip(got, want)) if skip else [(got, want)]
    ulps = max(_ulps(g, w) for g, w in pairs)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
    return ulps <= K22_ULPS, err


def _k22_cost(x, mask, gof, relu=False, residual=None, skip=False):
    """K22's bound: x, the mask, g and off and the residual read once, y
    (and the pre-ReLU output) written once; 2 to 4 flops an element."""
    e = x.element_size()
    nbytes = x.numel() * e * (2 + int(skip) + int(residual is not None)) \
        + mask.numel() + gof.numel() * 4
    return nbytes, 4.0 * x.numel(), "f32"


def _k22_class(x, mask, gof, relu=False, residual=None, skip=False):
    return (f"{x.shape[0]} x {x.shape[1]} "
            f"{_tail(relu, residual is not None, skip)}")


def check_norm_kernels(calls, what, bn_only=True):
    """K22 (the batch norm's apply) and K21 (the norms' backward, split by
    its launch counter: the batch norm's, and the instance norm's unless
    `bn_only`) on the recorded calls of `what`: against their plain
    versions, the same bits twice, their device kernels a call (K22 one,
    K21 one: a cooperative launch, the sums, each segment's coefficients
    and dx between grid barriers), their host cost. Returns the kernels
    line's rows."""
    from eyoc_tpu_torch.sparse import norm
    out = {}
    k22 = calls["masked_norm_apply"]
    label = f"K22 masked_norm_apply, {what}"
    out["masked_norm_apply"] = row = check_calls(
        label, k22, norm.masked_norm_apply, norm.masked_norm_apply_plain,
        _k22_cost, _k22_close, reps=SMALL_REPS // 4, classify=_k22_class)
    log(f"  {label}: library: none: F.batch_norm counts the padding rows")
    same_bits_twice(label, norm.masked_norm_apply, k22)
    a, k = k22[0]
    kernels_per_call(label, lambda: norm.masked_norm_apply(*a, **k))
    launch_path(label, norm.masked_norm_apply, k22, what, 10)
    by = {"masked_norm_backward_bn": [], "masked_norm_backward": []}
    for a, k in calls["masked_norm_backward"]:
        by[k["counter"]].append((a, k))
    for name, cl in by.items():
        if bn_only and name == "masked_norm_backward":
            if cl:
                raise AssertionError(f"{what}: an instance norm's backward")
            continue
        kind = "batch" if name.endswith("_bn") else "instance"
        label = f"K21 masked_norm_backward ({kind} norm), {what}"
        out[name] = check_calls(
            label, cl, norm.masked_norm_backward, _k21_plain, _k21_cost,
            _k21_close, reps=SMALL_REPS // 4, classify=_k21_class)
        log(f"  {label}: library: none: F.{kind}_norm's backward counts the "
            "padding rows")
        same_bits_twice(label, norm.masked_norm_backward, cl)
        a, k = cl[0]
        kernels_per_call(label, lambda: norm.masked_norm_backward(*a, **k),
                         expected=1)
        launch_path(label, norm.masked_norm_backward, cl, what, 10)
    for r in out.values():
        r["library_ms"] = None
    return out


def record_in_forward(model, pyr):
    """Every masked_instance_norm call of one eval forward."""
    import torch
    from eyoc_tpu_torch.models import unet
    with recording([(unet, "masked_instance_norm")]) as calls:
        model.embed(pyr)
    torch.cuda.synchronize()
    return calls["masked_instance_norm"]


def check_k20(pyr):
    """K20 on the calls of one full-width ResUNetIN2C eval forward (the
    kernels line's row): against the plain version in bf16 ulps, the same
    bits twice, two device kernels a call (the statistics with each cloud's
    g and off, then the apply), its host cost."""
    import torch
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.sparse import norm
    model = init_unet(load_model("ResUNetIN2C"),
                      torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    calls = record_in_forward(model, pyr)
    if len(calls) != IN_SPECS["ResUNetIN2C"]:
        raise AssertionError(f"ResUNetIN2C's forward made {len(calls)} K20 "
                             f"calls, not {IN_SPECS['ResUNetIN2C']}")
    what = "K20 masked_instance_norm, one ResUNetIN2C forward"
    fn, plain = norm.masked_instance_norm, norm.masked_instance_norm_plain
    row = check_calls(what, calls, fn, plain, _k20_cost, _k20_close,
                      classify=_k20_class)
    row["library_ms"] = None
    log(f"  {what}: library: none: F.instance_norm counts the padding rows")
    same_bits_twice(what, fn, calls)
    a, k = calls[0]
    kernels_per_call(what, lambda: fn(*a, **k), reps=3, expected=2)
    launch_path(what, fn, calls, "one ResUNetIN2C forward", 10)
    return row


def valid_phase(model, pairs, cfg, smi):
    """The valid step (`eval.valid_pair`) at full width on the eval pairs:
    finite metrics, one K2 and one K19 launch a pair and no K20 (counts
    reset just before, read just after); then `valid_metrics` on a known
    answer: cloud 1 is pair 0's voxelized cloud 0 under a known pose, row
    for row, both with the same random unit features and the same subset
    uniforms, so the correspondences are exact: RTE < 0.05 m, RRE < 0.1
    deg, hit ratio >= 0.99, loss < 0.01. Returns the launch counts."""
    import torch
    from eyoc_tpu_torch import eval as teval
    from eyoc_tpu_torch.geometry.se3 import integrate_trans, transform_points
    from eyoc_tpu_torch.utils import kernels
    gen = torch.Generator(device="cuda").manual_seed(7)
    teval.valid_pair(model, pairs[0].to("cuda"), cfg, generator=gen)
    torch.cuda.synchronize()
    kernels.reset_counts()
    ms = []
    for batch in pairs:
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = teval.valid_pair(model, batch, cfg, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in out.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"valid_pair: non-finite metrics {vals}")
        log("valid pair: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       vals.items()) + f", {ms[-1]:.2f} ms")
    counts = dict(kernels.launches)
    log(json.dumps({"valid_launch_counts": counts}))
    if counts["masked_argmin"] != N_PAIRS \
            or counts["est_quad_linear_robust"] != N_PAIRS \
            or counts["masked_instance_norm"]:
        raise AssertionError("the valid step is not one K2 and one K19 "
                             "launch a pair (and no K20)")
    log(f"valid path: ResUNetBN2C, {N_PAIRS} pairs, {np.mean(ms):.2f} "
        f"ms/pair (host clock around synchronized calls), on {smi}")
    # the known answer
    x0, _, m0, _, _, _ = teval.embed_pair(model, pairs[0].to("cuda"), cfg)
    yaw = 0.15
    R = torch.tensor([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    T = integrate_trans(R, torch.tensor([0.6, -0.4, 0.2])).cuda()
    x1 = transform_points(x0, T).contiguous()
    g = torch.Generator().manual_seed(11)
    f = torch.nn.functional.normalize(
        torch.randn(x0.shape[0], 32, generator=g), dim=1).cuda()
    u = torch.rand(x0.shape[0], generator=g).cuda()
    out = teval.valid_metrics(x0, f, m0, x1, f, m0, T, cfg, noise=(u, u))
    vals = {k: float(v) for k, v in out.items()}
    log(f"valid_metrics known answer (yaw {yaw} rad, t (0.6, -0.4, 0.2) m, "
        f"{int(m0.sum())} valid voxels): " + ", ".join(
            f"{k} {v:.3e}" for k, v in vals.items()))
    if not (vals["rte"] < 0.05 and vals["rre"] < 0.1
            and vals["hit_ratio"] >= 0.99 and vals["loss"] < 0.01):
        raise AssertionError("valid_metrics missed the known answer")
    return counts


def in_phase(pairs, cfg, smi):
    """The instance-norm family at full width: ResUNetIN2C and SimpleNetIN2
    (random weights) through the test protocol (SC2-PCR) and the valid
    step on pair 0: unit-norm features, zero at invalid voxels, finite
    poses and metrics, and one forward's K20 launches equal to the model's
    IN norms (IN_SPECS, and its InstanceNorm modules). Returns the launch
    counts of the phase's runs."""
    import torch
    from eyoc_tpu_torch import eval as teval
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.models.unet import InstanceNorm
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.utils import kernels
    batch = pairs[0].to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    models = {name: init_unet(load_model(name),
                              torch.Generator().manual_seed(0), 1, 32, 5,
                              device="cuda") for name in IN_SPECS}
    for model in models.values():                     # warm-up
        teval.test_pair(model, batch, cfg, generator=gen)
    torch.cuda.synchronize()
    kernels.reset_counts()
    for name, model in models.items():
        n_in = sum(isinstance(m, InstanceNorm) for m in model.modules())
        _, pyr = preprocess_clouds(batch.xyz0, batch.n0, caps=CAPS,
                                   voxel_size=0.3, window_bits=WINDOW_BITS)
        before = kernels.launches["masked_instance_norm"]
        model.embed(pyr)
        k20 = kernels.launches["masked_instance_norm"] - before
        if not k20 == n_in == IN_SPECS[name]:
            raise AssertionError(f"{name}: one forward launched {k20} K20, "
                                 f"the model has {n_in} IN norms, expected "
                                 f"{IN_SPECS[name]}")
        x0, f0, m0, x1, f1, m1 = teval.embed_pair(model, batch, cfg)
        for f, m in ((f0, m0), (f1, m1)):
            norms = f[m].norm(dim=1)
            if norms.numel() == 0 or float((norms - 1).abs().max()) > 1e-3:
                raise AssertionError(f"{name}: features are not unit-norm")
            if bool((f[~m] != 0).any()):
                raise AssertionError(f"{name}: features at invalid voxels "
                                     "are not 0")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = teval.test_pair(model, batch, cfg, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        val = teval.valid_pair(model, batch, cfg, generator=gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        vals = {k: float(v) for k, v in val.items()}
        if not (bool(torch.isfinite(out["T_est"]).all())
                and all(np.isfinite(v) for v in vals.values())):
            raise AssertionError(f"{name}: non-finite pose or metrics")
        log(f"{name}: {k20} K20 launches a forward ({n_in} IN norms), "
            f"test_pair {(t1 - t0) * 1e3:.2f} ms (RTE "
            f"{float(out['rte']):.3f} m, RRE {float(out['rre']):.3f} deg), "
            f"valid_pair {(t2 - t1) * 1e3:.2f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
            + f"), on {smi}")
    counts = dict(kernels.launches)
    log(json.dumps({"in_launch_counts": counts}))
    return counts


# ------------------------------------------------------------------ phase 8


# (instance norms, batch norms) of the IN specs, counted from the models'
# code: ResUNetIN2C's 14 IN block norms and 7 BN top-level norms;
# SimpleNetIN2's 8 IN norms (4 encoder, 3 decoder, conv1_tr's)
IN_TRAIN = {"ResUNetIN2C": (14, 7), "SimpleNetIN2": (8, 0)}


def norm_counts(model):
    """(instance norms, batch norms) of a ResUNet."""
    from eyoc_tpu_torch.models.unet import BatchNorm, InstanceNorm
    mods = list(model.modules())
    return (sum(isinstance(m, InstanceNorm) for m in mods),
            sum(isinstance(m, BatchNorm) for m in mods))


def norm_launches(counts, what, n_in, n_bn, steps, labeler=False):
    """The norm kernels' launches of `steps` train steps (and, with
    `labeler`, the labeler's two no-grad forwards a step): K20 forward and
    K21 backward for each instance norm of each side, K7 and K22 forward
    and K21 backward for each batch norm of each side."""
    fwd = 2 if labeler else 1
    want = {"masked_instance_norm": 2 * n_in * fwd,
            "masked_norm_backward": 2 * n_in,
            "masked_channel_sums": 2 * n_bn * fwd,
            "masked_norm_apply": 2 * n_bn * fwd,
            "masked_norm_backward_bn": 2 * n_bn}
    bad = {k: counts[k] for k, v in want.items() if counts[k] != v * steps}
    if bad:
        raise AssertionError(f"{what}: norm launches {bad}, expected a step "
                             f"{want}")
    log(f"{what}: norm launches a step {want} ({n_in} instance norms, "
        f"{n_bn} batch norms)")


def record_in_train_step(model, opt, batch, cfg, gen):
    """One base train step of an IN model with the norm kernels' wrapper
    calls recorded (K20 with its statistics, K22, K21)."""
    import torch
    from eyoc_tpu_torch.sparse import norm
    from eyoc_tpu_torch.training.steps import base_train_step
    sites = [(norm, "masked_instance_norm"), (norm, "masked_norm_apply"),
             (norm, "masked_norm_backward")]
    with recording(sites) as calls:
        base_train_step(model, opt, batch, cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    return calls


def check_in_train_kernels(calls, what):
    """K20 on the train forward's calls (with each cloud's statistics for
    the backward), K22 and K21 (both norms) on the recorded calls of
    `what`. Returns the kernels line's rows: K20's `_train` row and K21's
    instance-norm row."""
    from eyoc_tpu_torch.sparse import norm
    k20 = calls["masked_instance_norm"]
    if not all(k.get("with_stats") for _, k in k20):
        raise AssertionError("a train forward's K20 call without its "
                             "statistics")
    label = f"K20 masked_instance_norm (train forward), {what}"
    fn, plain = norm.masked_instance_norm, norm.masked_instance_norm_plain
    row = check_calls(label, k20, fn, plain, _k20_cost, _k20_close,
                      classify=_k20_class)
    row["library_ms"] = None
    log(f"  {label}: library: none: F.instance_norm counts the padding "
        "rows")
    same_bits_twice(label, fn, k20)
    out = check_norm_kernels(calls, what, bn_only=False)
    return {"masked_instance_norm_train": row,
            "masked_norm_backward": out["masked_norm_backward"]}


def in_train_steps(model, opt, batch, cfg, gen, steps, what, labeler=None,
                   tables=None):
    """`steps` train steps of an IN model (base steps, or extension steps
    with `labeler`), each with its draws made on the card beforehand and
    run under sync debug mode "error", launch counts reset before each and
    checked after it (`norm_launches`); finite metrics, finite grads, every
    parameter that gets a grad moved. Returns (the counts summed over the
    steps, host ms a step)."""
    import torch
    from eyoc_tpu_torch.training import steps as st
    from eyoc_tpu_torch.utils import kernels
    n_in, n_bn = norm_counts(model)
    total, ms = {}, []
    for i in range(steps):
        draws = st.draw(cfg, TRAIN_B, gen, "cuda", labels=labeler is not None)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        buffers = None if labeler is None else [
            b.clone() for b in labeler.buffers()]
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if labeler is None:
                m = st.base_train_step(model, opt, batch, cfg, draws=draws,
                                       device="cuda")
            else:
                m = st.extension_train_step(model, labeler, opt, batch, cfg,
                                            tables, draws=draws,
                                            device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(kernels.launches)
        norm_launches(counts, f"{what}, step {i}", n_in, n_bn, 1,
                      labeler=labeler is not None)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{what} step {i}: non-finite metrics "
                                 f"{vals}")
        grads = {k: p.grad for k, p in model.named_parameters()}
        if any(g is None or not bool(torch.isfinite(g).all())
               for g in grads.values()):
            raise AssertionError(f"{what}: a parameter has no or a "
                                 "non-finite grad")
        after = model.state_dict()
        still = [k for k, g in grads.items() if bool((g != 0).any())
                 and torch.equal(before[k], after[k])]
        if still or not any(bool((g != 0).any()) for g in grads.values()):
            raise AssertionError(f"{what}: parameters with a grad that did "
                                 f"not move: {still}")
        if buffers is not None and not all(
                torch.equal(a, b) for a, b in zip(buffers,
                                                  labeler.buffers())):
            raise AssertionError(f"{what}: the labeler's forwards changed "
                                 "its BN buffers")
        log(f"{what} step {i}: loss {vals['loss']:.6f} (pos "
            f"{vals['pos_loss']:.6f}, neg {vals['neg_loss']:.6f}), "
            f"{int(vals['num_pos_found'])} positives, {ms[-1]:.2f} ms, no "
            "host sync; every parameter with a grad moved")
    return total, ms


def in_train_phase(batch, tables, smi):
    """Training the instance-norm family at full width (phase 5's recipe
    and batch): ResUNetIN2C, a warm-up step, one recorded step whose norm
    kernels are held to their plain versions, TRAIN_STEPS counted steps
    and a profiled one; one extension step at phase 6's labeling (a fresh
    student and its labeler); SimpleNetIN2, one base step. Returns (the
    kernels line's rows, the counted steps' launches)."""
    import torch
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.steps import base_train_step
    cfg = ext_config()
    gen = torch.Generator().manual_seed(21)
    name = "ResUNetIN2C"
    spec = load_model(name)
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    if norm_counts(model) != IN_TRAIN[name]:
        raise AssertionError(f"{name}: norms {norm_counts(model)}, expected "
                             f"{IN_TRAIN[name]}")
    opt = sgd(model.parameters(), lr=0.1, momentum=0.8, weight_decay=1e-4)
    base_train_step(model, opt, batch, cfg, generator=gen, device="cuda")
    calls = record_in_train_step(model, opt, batch, cfg, gen)
    rows = check_in_train_kernels(calls, f"one {name} train step")
    del calls
    counts, ms = in_train_steps(model, opt, batch, cfg, gen, TRAIN_STEPS,
                                f"{name} train")
    log(f"IN train path: {name}, B={TRAIN_B}, {TRAIN_STEPS} steps, "
        f"{np.mean(ms):.2f} ms/step (host clock around synchronized steps, "
        f"under sync debug mode \"error\"), on {smi}")
    train_breakdown(model, opt, batch, cfg, gen, what=f"{name} train")
    del model, opt
    student, labeler, opt, _ = ext_models(spec)
    _, ms = in_train_steps(student, opt, batch, cfg, gen, 1,
                           f"{name} extension", labeler=labeler,
                           tables=tables)
    log(f"IN extension step: {name}, B={TRAIN_B}, {ms[0]:.2f} ms (one step, "
        f"its first), on {smi}")
    del student, labeler, opt
    name = "SimpleNetIN2"
    model = init_unet(load_model(name), torch.Generator().manual_seed(0), 1,
                      32, 5, device="cuda")
    if norm_counts(model) != IN_TRAIN[name]:
        raise AssertionError(f"{name}: norms {norm_counts(model)}, expected "
                             f"{IN_TRAIN[name]}")
    opt = sgd(model.parameters(), lr=0.1, momentum=0.8, weight_decay=1e-4)
    _, ms = in_train_steps(model, opt, batch, cfg, gen, 1, f"{name} train")
    log(f"IN train path: {name}, B={TRAIN_B}, {ms[0]:.2f} ms (one step, its "
        f"first), on {smi}")
    return rows, counts


# ---------------------------------------------------- phase 2, labeling


def ext_config(**over):
    """The EYOC extension step at the published KITTI recipe
    (scripts/train_kitti_EYOC.sh:47-65 with eyoc_tpu/training/trainer.py:
    45-99 and eyoc_tpu/config.py:223-227): feature filter "None",
    Similarity over the waymo tables at 0.6, hit-ratio threshold 0.3,
    SC2-PCR at the KITTI config (8000 points, ratio 0.2: 1600 seeds, k1 30,
    k2 20), 5000 matches a direction, 5000 rediscovery samples within 2 m;
    `over` replaces fields (the demo's gates: GATED)."""
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
    from eyoc_tpu_torch.training.steps import TrainConfig
    kw = dict(caps=CAPS, voxel_size=0.3, num_pos=1024 * TRAIN_B,
              num_hn_samples=256 * TRAIN_B, window_bits=WINDOW_BITS,
              num_corres=5000, feature_filter="None",
              spatial_filter="Similarity", filter_radius=40.0,
              similarity_thresh=0.6, hit_ratio_thresh=0.3,
              sc2=SC2PCRConfig(max_points=LABEL_N),
              rediscovery_samples=REDISCOVERY)
    kw.update(over)
    return TrainConfig(**kw)


def ext_models(spec):
    """A fresh student (phase 5's generator), its SGD and its labeler after
    the trainer's first sync (a copy): (student, labeler, opt, count)."""
    import copy
    import torch
    from eyoc_tpu_torch.models import init_unet
    from eyoc_tpu_torch.training.optim import sgd, sync_labeler
    student = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                        device="cuda")
    labeler = copy.deepcopy(student)
    n = sync_labeler(labeler, student, 0)
    opt = sgd(student.parameters(), lr=0.1, momentum=0.8, weight_decay=1e-4)
    return student, labeler, opt, n


def record_extension_steps(spec, batch, tables):
    """One extension step at the published recipe and one at the demo's
    gates (fresh models each), with the labeling kernels' wrapper calls
    recorded: K2 (the matching, both directions of every pair in one
    batched call, and the rediscovery), K3, K4 and K13-K15, then K8 and
    K9."""
    import torch
    from eyoc_tpu_torch.ops import matching
    from eyoc_tpu_torch.registration import sc2pcr
    from eyoc_tpu_torch.training import loss, steps
    gen = torch.Generator().manual_seed(6)
    sites = [(matching, "masked_knn_batched"), (loss, "masked_argmin_excl"),
             (steps, "masked_argmin_batched"),
             (sc2pcr, "sc2_power_iteration"), (sc2pcr, "sc2_seed_topk"),
             (sc2pcr, "sc2_nms"), (sc2pcr, "sc2_seed_transforms"),
             (sc2pcr, "sc2_irls")]
    calls = {}
    for cfg in (ext_config(), ext_config(**GATED)):
        student, labeler, opt, _ = ext_models(spec)
        with recording(sites) as got:
            steps.extension_train_step(student, labeler, opt, batch, cfg,
                                       tables, generator=gen, device="cuda")
        torch.cuda.synchronize()
        calls[cfg.feature_filter] = got
    pub, gated = calls["None"], calls["Lowe"]
    # the matching at k = 1 is masked_argmin_batched (K2) on the card
    match = [(a[:4], {}) for a, _ in pub["masked_knn_batched"] if a[4] == 1]
    return {"masked_argmin_label": match + pub["masked_argmin_batched"],
            "sc2_power_iteration": pub["sc2_power_iteration"],
            "sc2_seed_topk": pub["sc2_seed_topk"],
            **{k: pub[k] for k in ("sc2_nms", "sc2_seed_transforms",
                                   "sc2_irls")},
            "masked_knn2": [c for c in gated["masked_knn_batched"]
                            if c[0][4] == 2],
            "masked_argmin_excl": gated["masked_argmin_excl"]}


def _label_argmin_class(q, qm, r, rm):
    """K2's classes on the labeling path: the matching (D = 32, both
    directions of every pair) and the rediscovery (D = 3)."""
    what = "matching" if q.shape[-1] == 32 else "rediscovery"
    return f"{what}, D = {q.shape[-1]}, batch {q.shape[0]}"


def _power_cost(src, tgt, valid, d_thre, iters, bf16=False):
    """K3's bound: each unordered valid pair (and the diagonal) once per
    iteration, ~24 flops each, as check_power_iteration (the bf16 form's
    two roundings a pair aside)."""
    n, nv = src.shape[0], int(valid.sum())
    return (2 * n * 12 + n + n * 4, iters * nv * (nv + 1) / 2 * 24.0,
            "f32")


def _power_close(got, want, src, tgt, valid, d_thre, iters, bf16=False):
    """K3 within K3_RTOL / K3_ATOL of its plain version or, where the input
    is ill-conditioned (the labeling's noise correspondences at up to 76 m:
    an f32 rounding of a ~100 m distance moves an SC value by up to ~4e-4,
    and a small eigengap carries that into the vector), no further from
    the plain version run in f64 than twice the f32 plain version is
    (K3_F64_FACTOR)."""
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import sc2_power_iteration_plain
    err = float((got - want).abs().max())
    if bool(torch.allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)):
        return True, err
    ref = sc2_power_iteration_plain(src.double(), tgt.double(), valid,
                                    d_thre, iters, bf16)
    e_k = float((got.double() - ref).abs().max())
    e_p = float((want.double() - ref).abs().max())
    log(f"  K3 off its f32 plain version by {err:.3e}: the f64 plain "
        f"version puts the kernel {e_k:.3e} and the f32 plain {e_p:.3e} "
        "away")
    return e_k <= K3_F64_FACTOR * e_p + K3_ATOL, err


def _topk_cost(src, tgt, valid, seeds, d_thre, k):
    """K4's bound: its S x nv x nv binary products at the b1 rate."""
    n, ns, nv = src.shape[0], seeds.shape[0], int(valid.sum())
    return (2 * n * 12 + n + ns * 4 + ns * k * 4, 2.0 * ns * nv * nv, "b1")


def _exact(got, want, *a):
    import torch
    return bool(torch.equal(got, want)), float((got != want).sum())


def _f64_smallest(q, r, rm, k, chunk=2048):
    """The k smallest direct-form f64 squared distances [Nq, k] from each
    query to the valid refs (1e30 past the valid ones)."""
    import torch
    out = []
    rd = r.double()
    for q0 in range(0, q.shape[0], chunk):
        d = torch.cdist(q[q0:q0 + chunk].double(), rd,
                        compute_mode="donot_use_mm_for_euclid_dist") ** 2
        d += torch.where(rm, 0.0, 1e30).double()[None]
        out.append(torch.topk(d, k, largest=False).values)
        del d
    return torch.cat(out)


def _knn2_close(got, want, q, qm, r, rm, k, gap=K2_GAP):
    """K8 against the plain version's Gram form, each problem on its own:
    d2 within K2_D2_RTOL plus the Gram form's rounding (1e-6 of |q|^2 +
    max |r|^2) where a valid ref fills the place; the first index equal
    where the first and second nearest valid refs (f64, direct form) are
    more than K2_GAP plus that rounding apart, the second index where the
    second and third are too."""
    import torch
    (d_k, i_k), (d_p, i_p) = got, want
    worst, ok = 0.0, True
    for b in range(q.shape[0]):
        gram = 1e-6 * ((q[b] * q[b]).sum(1) + float((r[b] * r[b]).sum(1)
                                                      .max()))
        found = qm[b][:, None] & (d_p[b] < 1e29)
        err = (d_k[b] - d_p[b]).abs()
        ok &= bool((err <= K2_D2_RTOL * d_p[b].abs() + gram[:, None])
                   [found].all())
        ok &= bool(torch.equal(d_k[b][~found], d_p[b][~found]))
        t = _f64_smallest(q[b], r[b], rm[b], 3)
        g = gap + 2 * gram.double()
        clear0 = qm[b] & (t[:, 1] - t[:, 0] > g)
        clear1 = clear0 & (t[:, 2] - t[:, 1] > g)
        ok &= bool(torch.equal(i_k[b][clear0, 0], i_p[b][clear0, 0]))
        ok &= bool(torch.equal(i_k[b][clear1, 1], i_p[b][clear1, 1]))
        worst = max(worst, float(err[found].max()) if bool(found.any())
                    else 0.0)
    return ok, worst


def _knn2_pairs(q, qm, r, rm):
    return float((qm.sum(1).double() * rm.sum(1).double()).sum())


def _knn2_cost(q, qm, r, rm, k):
    """K8's bound on the tensor cores: the cross term's 3xTF32 products
    (3 x 2 D flops a valid pair) at the TF32 rate, and, on the CUDA cores
    that issue beside them, the epilogue's three f32 instructions a pair
    (the FMA, the add of |r|^2, the compare; each at the FMA's rate, 6
    flops; the clamp at 0 only for a candidate that passes the compare)
    and the norms (2 D a valid row). The second count: the direct form's
    2 D flops a valid pair at the f32 rate alone (the bound of K8's first
    design)."""
    nq, nr, D = qm.numel(), rm.numel(), q.shape[-1]
    pairs = _knn2_pairs(q, qm, r, rm)
    rows = float(qm.sum() + rm.sum())
    return (nq + nr) * D * 4 + nq + nr + nq * k * 8, {
        "tf32": 6.0 * pairs * D, "f32": 6.0 * pairs + 2.0 * D * rows}, \
        None, (2.0 * pairs * D, "f32")


def _excl_close(got, want, a, c, pxyz, cxyz, r2):
    """K9 against the plain version: the kernel's exclusion test is the
    direct form, the plain version's pdist2's Gram form; an exclusion test
    on which the two disagree must lie within 1e-4 r^2 of the radius (the
    count of such tests is logged). On every anchor with no test in that
    band, the every-candidate-excluded flags are equal, and the indices
    equal where the nearest and second nearest kept candidates (f64,
    direct form) are more than K2_GAP apart. Returns the count of
    differing indices on those anchors (0)."""
    import torch
    from eyoc_tpu_torch.geometry.metrics import pdist2
    (i_k, e_k), (i_p, e_p) = got, want
    d2x = torch.cdist(pxyz.double(), cxyz.double(),
                      compute_mode="donot_use_mm_for_euclid_dist") ** 2
    near = d2x < r2
    band = (d2x - r2).abs() < 1e-4 * r2
    disagree = near != (pdist2(pxyz, cxyz) < r2)
    if bool((disagree & ~band).any()):
        return False, float("inf")
    sure = ~band.any(1)
    d = torch.cdist(a.double(), c.double(),
                    compute_mode="donot_use_mm_for_euclid_dist") ** 2
    d[near] = float("inf")
    two = torch.topk(d, 2, largest=False).values
    clear = sure & (two[:, 1] - two[:, 0] > K2_GAP)
    wrong = int((i_k[clear] != i_p[clear]).sum())
    ok = wrong == 0 and bool(torch.equal(e_k[sure], e_p[sure]))
    log(f"  K9: {int(disagree.sum())} of {disagree.numel()} exclusion tests "
        f"differ from the Gram form (all within 1e-4 r^2), "
        f"{int((~sure).sum())} anchors with a test in that band, "
        f"{int(clear.sum())} clear anchors equal, "
        f"{int(e_k.sum())} with every candidate excluded")
    return ok, float(wrong)


def _excl_cost(a, c, pxyz, cxyz, r2):
    """K9's bound in K8's convention: the cross term's 3xTF32 products (6 D
    flops a pair) at the TF32 rate and, on the CUDA cores that issue beside
    them, the epilogue's FMA, add of |c|^2 and compare (6 flops a pair at
    the FMA's rate; an exclusion test only for a pair that wins) and the
    norms (2 D a row). The second count: the direct form's 2 D flops and
    the exclusion test's 8 a pair at the f32 rate alone (the bound of K9's
    first design). Bytes: the features and coordinates once; d2, idx and
    the flag an anchor."""
    P, M, D = a.shape[0], c.shape[0], a.shape[1]
    pairs = float(P) * M
    return (P + M) * (D + 3) * 4 + P * 9, {
        "tf32": 6.0 * pairs * D, "f32": 6.0 * pairs + 2.0 * D * (P + M)}, \
        None, (pairs * (2.0 * D + 8.0), "f32")


def check_label_kernels(calls):
    """K2 on the labeling path (the matching and the rediscovery of one
    published-recipe step), K3 and K4 on that step's 8 SC2-PCR calls (N =
    8000, S = 1600), K8 on the gated step's matching ([2B, 16384, 32]) and
    K9 on its two minings (num_pos x num_hn_samples, r = 1.5 m)."""
    from eyoc_tpu_torch.ops import knn
    from eyoc_tpu_torch.registration import sc2pcr

    out = {}
    k2 = calls["masked_argmin_label"]
    shapes = sorted((tuple(a[0].shape)) for a, _ in k2)
    if shapes != sorted([(2 * TRAIN_B, CAPS[0], 32),
                         (TRAIN_B, min(REDISCOVERY, CAPS[0]), 3)]):
        raise AssertionError(f"the labeling's K2 calls are {shapes}, not "
                             "one batched matching and one rediscovery")
    out["masked_argmin_label"] = check_calls(
        "K2 masked_argmin, the labeling of one step (the matching of both "
        "directions of 8 pairs in one call, the rediscovery in one call)",
        k2, knn.masked_argmin_batched, knn.masked_argmin_batched_plain,
        _argmin_cost, _argmin_close, classify=_label_argmin_class)
    same_bits_twice("K2 masked_argmin (labeling)", knn.masked_argmin_batched,
                    k2)
    for name, fn, plain, cost, close, kernels_a_call in (
            ("sc2_power_iteration", sc2pcr.sc2_power_iteration,
             sc2pcr.sc2_power_iteration_plain, _power_cost, _power_close, 1),
            ("sc2_seed_topk", sc2pcr.sc2_seed_topk,
             sc2pcr.sc2_seed_topk_plain, _topk_cost, _exact, 3)):
        cl = calls[name]
        (src, _, _, *rest), _ = cl[0]
        if len(cl) != TRAIN_B or src.shape[0] != LABEL_N or (
                name == "sc2_seed_topk" and rest[0].shape[0] != LABEL_S):
            raise AssertionError(f"{name}: {len(cl)} calls at N = "
                                 f"{src.shape[0]} in one labeling")
        label = f"{name} at N = {LABEL_N}" + (
            f", S = {LABEL_S}" if name == "sc2_seed_topk" else "")
        a, k = cl[0]
        kernels_per_call(label, lambda: fn(*a, **k), expected=kernels_a_call)
        out[f"{name}_label"] = check_calls(
            f"{label}, the {len(cl)} calls of one labeling", cl, fn, plain,
            cost, close)
        same_bits_twice(label, fn, cl)
        launch_path(label, fn, cl, "one labeling", 20)

    k8 = calls["masked_knn2"]
    (q, qm, r, rm, _), _ = k8[0]
    if len(k8) != 1 or tuple(q.shape) != (2 * TRAIN_B, CAPS[0], 32):
        raise AssertionError(f"K8: {len(k8)} calls, first {tuple(q.shape)}")
    kernels_per_call("K8 masked_knn2",
                     lambda: knn.masked_knn_batched(q, qm, r, rm, 2))
    out["masked_knn2"] = check_calls(
        f"K8 masked_knn2, the gated step's matching {tuple(q.shape)}", k8,
        knn.masked_knn_batched, knn.masked_knn_batched_plain, _knn2_cost,
        _knn2_close)
    same_bits_twice("K8 masked_knn2", knn.masked_knn_batched, k8)
    launch_path("K8 masked_knn2", knn.masked_knn_batched, k8,
                "the gated step's matching", 20)
    k9 = calls["masked_argmin_excl"]
    (a, c, px, cx, r2), _ = k9[0]
    if len(k9) != 2 or a.shape != (1024 * TRAIN_B, 32) \
            or c.shape != (256 * TRAIN_B, 32):
        raise AssertionError(f"K9: {len(k9)} calls, first {tuple(a.shape)}"
                             f" x {tuple(c.shape)}")
    kernels_per_call("K9 masked_argmin_excl",
                     lambda: knn.masked_argmin_excl(a, c, px, cx, r2))
    out["masked_argmin_excl"] = check_calls(
        f"K9 masked_argmin_excl, the gated step's two minings "
        f"{tuple(a.shape)} x {tuple(c.shape)}, r^2 = {r2}", k9,
        knn.masked_argmin_excl, knn.masked_argmin_excl_plain, _excl_cost,
        _excl_close, reps=SMALL_REPS)
    same_bits_twice("K9 masked_argmin_excl", knn.masked_argmin_excl, k9)
    launch_path("K9 masked_argmin_excl", knn.masked_argmin_excl, k9,
                "the gated step's minings", 200)
    return out


# ------------------------------------------------------- phase 4, options


# the kernels line's rows of SC2PCRConfig's switches: row -> (phase 4's
# run, its counter)
OPTION_ROWS = {
    "sc2_power_iteration_bf16": ("bf16", "sc2_power_iteration_bf16"),
    "sc2_seed_transforms_jacobi": ("jacobi", "sc2_seed_transforms_jacobi"),
    "sc2_irls_jacobi": ("jacobi", "sc2_irls_jacobi"),
    "sc2_seed_transforms_jacobi_label": ("jacobi_label",
                                         "sc2_seed_transforms_jacobi"),
    "sc2_irls_jacobi_label": ("jacobi_label", "sc2_irls_jacobi"),
    "sc2_irls_unroll": ("unroll", "sc2_irls"),
    "sc2_irls_jacobi_unroll": ("jacobi_unroll", "sc2_irls_jacobi"),
}
# SC2PCRConfig's switches in phase 4: (tag, fields, the counters that the
# run must launch once a problem (K3) or once (K13-K15, K23, K24), and the
# ones it must not launch)
SC2_OPTIONS = (
    ("jacobi", dict(qcp_kabsch=False),
     ("sc2_seed_transforms_jacobi", "sc2_irls_jacobi"),
     ("sc2_seed_transforms", "sc2_irls")),
    ("unroll", dict(refine_unroll=UNROLL), ("sc2_irls",),
     ("sc2_irls_jacobi",)),
    ("jacobi_unroll", dict(qcp_kabsch=False, refine_unroll=UNROLL),
     ("sc2_seed_transforms_jacobi", "sc2_irls_jacobi"),
     ("sc2_seed_transforms", "sc2_irls")),
    ("bf16", dict(bf16_power=True), ("sc2_power_iteration_bf16",),
     ("sc2_power_iteration",)),
    ("approx", dict(approx_topk=True), ("sc2_power_iteration",
                                        "sc2_seed_transforms"), ()),
)


def sc2_option_runs(sanity, src, tgt, valid, T_true, base, l_cfg):
    """Phase 4's known-pose problems again under each of SC2_OPTIONS:
    `sc2_pcr_batched` (launch counts reset just before, read just after)
    recovers each pose within phase 4's tolerances, each problem the same
    bits as its own B = 1 `sc2_pcr`; then the labeling shape's synthetic
    problems (B = 8, N = 8000) under qcp_kabsch=False, finite. Returns
    {tag: launch counts} (the kernels line's Jacobi, unroll and bf16 rows
    take theirs; "jacobi_label" the labeling shape's)."""
    import dataclasses

    import torch
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.registration.sc2pcr import sc2_pcr, sc2_pcr_batched
    from eyoc_tpu_torch.utils import kernels
    out = {}
    for tag, fields, must, never in SC2_OPTIONS:
        c = dataclasses.replace(base, **fields)
        torch.cuda.synchronize()
        kernels.reset_counts()
        T_est, fit = sc2_pcr_batched(src, tgt, valid, c)
        torch.cuda.synchronize()
        counts = out[tag] = dict(kernels.launches)
        want = {k: (src.shape[0] if k.startswith("sc2_power") else 1)
                for k in must}
        if any(counts[k] != n for k, n in want.items()) or any(
                counts[k] for k in never):
            raise AssertionError(f"sc2_pcr_batched ({tag}) launched "
                                 f"{ {k: v for k, v in counts.items() if v} }")
        res = []
        for b, (inlier, nv) in enumerate(sanity):
            T1, f1 = sc2_pcr(src[b], tgt[b], valid[b], c)
            if not (torch.equal(T1, T_est[b]) and torch.equal(f1, fit[b])):
                raise AssertionError(f"sc2_pcr_batched ({tag}) problem {b} "
                                     "differs from its own B = 1 call")
            _, te, re = registration_success(T_est[b], T_true[b])
            if not (float(te) < 0.1 and float(re) < 1.0):
                raise AssertionError(
                    f"sc2_pcr_batched ({tag}) missed a known pose ({inlier} "
                    f"inliers, {nv} valid rows): RTE {float(te)} m, RRE "
                    f"{float(re)} deg")
            res.append(f"{float(te):.4f} m / {float(re):.4f} deg")
        log(f"sc2_pcr_batched sanity, {tag} ({fields}): RTE / RRE "
            + ", ".join(res) + "; each problem the same bits as its B = 1 "
            "call; launches " + str({k: counts[k] for k in must}))
    l_jac = dataclasses.replace(l_cfg, qcp_kabsch=False)
    l_set = jacobi_label_set()
    torch.cuda.synchronize()
    kernels.reset_counts()
    T_l, _ = sc2_pcr_batched(*l_set, l_jac)
    torch.cuda.synchronize()
    out["jacobi_label"] = dict(kernels.launches)
    if not bool(torch.isfinite(T_l).all()):
        raise AssertionError("sc2_pcr_batched (labeling shape, "
                             "qcp_kabsch=False): non-finite poses")
    log(f"sc2_pcr_batched (labeling shape, B = {T_l.shape[0]}, N = "
        f"{LABEL_N}, qcp_kabsch=False): finite; launches "
        + str({k: v for k, v in out["jacobi_label"].items() if v}))
    return out


# ------------------------------------------------------------------ phase 5


def train_phase(model, opt, batch, cfg, gen, smi):
    """The training path at full width: one warm-up step, then the timed
    steps with launch counts reset just before them."""
    import torch
    from eyoc_tpu_torch.training.steps import base_train_step
    from eyoc_tpu_torch.utils import kernels

    coord_path_checks("train path, cloud 0 of each pair", batch.xyz0,
                      batch.n0, inverse=True)
    torch.cuda.reset_peak_memory_stats()     # the peak of this phase alone
    base_train_step(model, opt, batch, cfg, generator=gen,      # warm-up
                    device="cuda")
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    stage_ms, step_ms = {}, []
    kernels.reset_counts()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = base_train_step(model, opt, batch, cfg, generator=gen,
                            device="cuda", timings=stage_ms)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {vals}")
        if vals["num_pos_found"] <= 0:
            raise AssertionError(f"train step {i}: no positive pairs")
        log(f"train step {i}: loss {vals['loss']:.6f} (pos "
            f"{vals['pos_loss']:.6f}, neg {vals['neg_loss']:.6f}), "
            f"{int(vals['num_pos_found'])} positives, {step_ms[-1]:.2f} ms")
    counts = dict(kernels.launches)
    log(json.dumps({"train_launch_counts": counts}))
    missing = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"train step launched no {missing}")
    # both sides' preprocess and train forward (with inverses), each step
    if any(counts[k] != 2 * TRAIN_STEPS for k in COORD_KERNELS):
        raise AssertionError("the train steps are not one K10, K11 and K12 "
                             "call for each side of each step")
    # each BN norm of each side: K7's sums and K22's apply forward, K21's
    # backward; no instance norm
    n_bn = norm_counts(model)[1]
    norm_launches(counts, "ResUNetBN2C train steps", 0, n_bn, TRAIN_STEPS)

    grads = [p.grad for p in model.parameters()]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("a parameter has no or a non-finite grad")
    if not any(bool((g != 0).any()) for g in grads):
        raise AssertionError("every grad is zero")
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    stats = {k for k in before if k.endswith(("running_mean", "running_var"))}
    params = set(before) - stats
    if not (moved & params) or not (moved & stats):
        raise AssertionError("the step moved no parameter or no BN statistic")
    log(f"train: {len(moved & params)}/{len(params)} parameters and "
        f"{len(moved & stats)}/{len(stats)} BN statistics moved")
    split = ", ".join(f"{k} {v / TRAIN_STEPS:.2f}"
                      for k, v in stage_ms.items())
    log(f"train path: ResUNetBN2C, B={TRAIN_B}, {TRAIN_STEPS} steps, "
        f"{np.mean(step_ms):.2f} ms/step ({split} ms; host clock around "
        f"synchronized stages), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {smi}")
    train_breakdown(model, opt, batch, cfg, gen)
    return counts


def train_breakdown(model, opt, batch, cfg, gen, what="train"):
    """Where a train step's time goes, after the counted run: the conv maps
    of one side (with and without their inverses), then torch.profiler over
    one step (device time, busy share, the kernels with most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eyoc_tpu_torch.sparse.brick_conv import conv_maps
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import base_train_step

    _, pyr = preprocess_clouds(batch.xyz0, batch.n0, caps=cfg.caps,
                               voxel_size=cfg.voxel_size,
                               window_bits=cfg.window_bits)
    maps_ms = []
    for inverse in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv_maps(pyr, 4, 5, inverse=inverse)
        torch.cuda.synchronize()
        maps_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"{what}: conv maps of one side {maps_ms[0]:.2f} ms, with their "
        f"inverses {maps_ms[1]:.2f} ms (host clock, synchronized)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        base_train_step(model, opt, batch, cfg, generator=gen, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(_dev_ms(e) for e in events)
    log(f"{what} profiler, one step: wall {wall:.3f} ms (profiler on), "
        f"device time {total:.3f} ms, busy share {total / wall:.3f}, "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=lambda e: -_dev_ms(e))[:12]:
        log(f"  {_dev_ms(e):9.3f} ms  x{e.count:5d}  {e.key[:80]}")


def largest_sort(model, batch, cfg, gen, limit, what, forbid=()):
    """The profiler's view of one eval pair: no sort or top-k on the path
    runs over as many as `limit` elements (SC2-PCR: S x N, the [S, N]
    counts are gone; RANSAC: H, the coarse counts' sort is gone), nor over
    a shape in `forbid` (SC2-PCR: K13's [1, N] scores, sorted no more)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eyoc_tpu_torch.eval import embed_pair, register_pair
    x = embed_pair(model, batch, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        register_pair(*x, cfg, generator=gen)
        torch.cuda.synchronize()
    shapes = [tuple(e.input_shapes[0] or ()) for e in prof.events()
              if e.name in ("aten::sort", "aten::topk") and e.input_shapes]
    largest = max((int(np.prod(sh)) for sh in shapes), default=0)
    log(f"{what}: {len(shapes)} sorts or top-ks, the largest over {largest} "
        f"elements ({sorted(set(shapes))})")
    if largest >= limit:
        raise AssertionError(f"a sort over {largest} elements on the "
                             f"{what}'s path")
    if any(sh in forbid for sh in shapes):
        raise AssertionError(f"a sort of shape {forbid} on the {what}'s "
                             "path")


# ------------------------------------------------------------------ phase 6


LABEL_KERNELS = ("sparse_conv", "sparse_conv_dgrad", "sparse_conv_wgrad",
                 "take_rows", "take_rows_backward", "masked_channel_sums",
                 "masked_norm_apply", "masked_norm_backward_bn",
                 "masked_argmin", "sc2_power_iteration",
                 "sc2_seed_topk", "sc2_nms", "sc2_seed_transforms",
                 "sc2_irls") + COORD_KERNELS


def ema_synced(labeler, student, n, before):
    """The labeler after an EMA sync at count n from the parameters
    `before` is the formula's, bit for bit, and its BN buffers are the
    student's."""
    import torch
    from eyoc_tpu_torch.training.optim import ema_update
    for (name, p), q in zip(labeler.named_parameters(), student.parameters()):
        if not torch.equal(p, ema_update(before[name], q, EXT_DECAY, n)):
            raise AssertionError(f"labeler {name} is not the EMA formula")
    for b, c in zip(labeler.buffers(), student.buffers()):
        if not torch.equal(b, c):
            raise AssertionError("the labeler's BN buffers are not the "
                                 "student's after the sync")


def extension_phase(spec, batch, tables, smi):
    """The EYOC extension step at full width and the published recipe: one
    warm-up step, then EXT_STEPS timed steps, each followed by the EMA
    labeler sync, with launch counts reset just before them; the batch
    and shapes of every K2 launch of the run recorded. Returns the
    counts."""
    import torch
    from eyoc_tpu_torch.ops import knn
    from eyoc_tpu_torch.training.optim import sync_labeler
    from eyoc_tpu_torch.training.steps import extension_train_step
    from eyoc_tpu_torch.utils import kernels

    coord_path_checks("extension path, cloud 1 of each pair", batch.xyz1,
                      batch.n1, inverse=True)
    student, labeler, opt, n = ext_models(spec)
    cfg = ext_config()
    gen = torch.Generator().manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    extension_train_step(student, labeler, opt, batch, cfg, tables,
                         generator=gen, device="cuda")      # warm-up
    n = sync_labeler(labeler, student, n, "EMA", EXT_DECAY)
    torch.cuda.synchronize()
    stage_ms, step_ms, k2 = {}, [], []
    real = knn._launch

    def launch(*args):      # the shapes only: the tensors would add to the peak
        k2.append(tuple(args[4:8]))
        return real(*args)

    kernels.reset_counts()
    knn._launch = launch
    try:
        for i in range(EXT_STEPS):
            buffers = [b.clone() for b in labeler.buffers()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = extension_train_step(student, labeler, opt, batch, cfg,
                                     tables, generator=gen, device="cuda",
                                     timings=stage_ms)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if not all(torch.equal(a, b)
                       for a, b in zip(buffers, labeler.buffers())):
                raise AssertionError("the labeler's forwards changed its BN "
                                     "buffers")
            vals = {k: float(v) for k, v in m.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"extension step {i}: non-finite "
                                     f"metrics {vals}")
            before = {k: p.detach().clone()
                      for k, p in labeler.named_parameters()}
            t0 = time.perf_counter()
            n_before, n = n, sync_labeler(labeler, student, n, "EMA",
                                          EXT_DECAY)
            torch.cuda.synchronize()
            stage_ms["sync"] = stage_ms.get("sync", 0.0) + (
                time.perf_counter() - t0) * 1e3
            ema_synced(labeler, student, n_before, before)
            log(f"extension step {i}: loss {vals['loss']:.6f} (pos "
                f"{vals['pos_loss']:.6f}, neg {vals['neg_loss']:.6f}), "
                f"{int(vals['num_pos_found'])} positives, labeler hit ratio "
                f"{vals['labeler_hit_ratio']:.4f}, {step_ms[-1]:.2f} ms; "
                f"labeler buffers unchanged, EMA sync {n_before} exact")
    finally:
        knn._launch = real
    counts = dict(kernels.launches)
    log(json.dumps({"extension_launch_counts": counts}))
    missing = [k for k in LABEL_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"extension step launched no {missing}")
    # K12: the labeler's two forwards (no grad: no inverses) and the
    # student's two
    want = {"sc2_power_iteration": TRAIN_B, "sc2_seed_topk": TRAIN_B,
            "sc2_nms": 1, "sc2_seed_transforms": 1, "sc2_irls": 1,
            "masked_argmin": 4, "sc2_seed_counts": 0, "masked_knn2": 0,
            "masked_argmin_excl": 0, "voxelize": 2, "brick_pyramid": 2,
            "conv_maps": 4}
    bad = {k: counts[k] for k, v in want.items()
           if counts[k] != v * EXT_STEPS}
    if bad:
        raise AssertionError(f"extension launches {bad}, expected a step "
                             f"{want}")
    norm_launches(counts, "extension steps", *norm_counts(student),
                  EXT_STEPS, labeler=True)
    match = (2 * TRAIN_B, CAPS[0], CAPS[0], 32)
    redisc = (TRAIN_B, min(REDISCOVERY, CAPS[0]), CAPS[0], 3)
    mine = (1, 1024 * TRAIN_B, 256 * TRAIN_B, 32)
    if sorted(k2) != sorted([match, redisc, mine, mine] * EXT_STEPS):
        raise AssertionError(f"K2 launches of the steps: {k2}")
    log(f"extension: each step's K2 launches (B, Nq, Nr, D): one {match} "
        f"for the matching of both directions of every pair, one {redisc} "
        f"for the rediscovery, two {mine} for the mining")
    split = ", ".join(f"{k} {v / EXT_STEPS:.2f}" for k, v in stage_ms.items())
    log(f"extension path: ResUNetBN2C, B={TRAIN_B}, {EXT_STEPS} steps, "
        f"{np.mean(step_ms):.2f} ms/step ({split} ms; host clock around "
        f"synchronized stages, sc2pcr summed over the {TRAIN_B} pairs), "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {smi}")
    extension_breakdown(student, labeler, opt, batch, cfg, tables, gen)
    return counts


def extension_breakdown(student, labeler, opt, batch, cfg, tables, gen):
    """torch.profiler over one more extension step: device time, busy
    share, the kernels with most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eyoc_tpu_torch.training.steps import extension_train_step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extension_train_step(student, labeler, opt, batch, cfg, tables,
                             generator=gen, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(_dev_ms(e) for e in events)
    log(f"extension profiler, one step: wall {wall:.3f} ms (profiler on), "
        f"device time {total:.3f} ms, busy share {total / wall:.3f}, "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=lambda e: -_dev_ms(e))[:12]:
        log(f"  {_dev_ms(e):9.3f} ms  x{e.count:5d}  {e.key[:80]}")


def gated_step(spec, batch, tables):
    """One extension step at the demo's gates (Lowe, Spherical, safe-radius
    mining, translation floor), counts reset just before: K8 once (both
    directions of every pair) and K9 twice. Returns the counts."""
    import torch
    from eyoc_tpu_torch.training.steps import extension_train_step
    from eyoc_tpu_torch.utils import kernels
    student, labeler, opt, _ = ext_models(spec)
    gen = torch.Generator().manual_seed(8)
    kernels.reset_counts()
    m = extension_train_step(student, labeler, opt, batch, ext_config(**GATED),
                             tables, generator=gen, device="cuda")
    vals = {k: float(v) for k, v in m.items()}
    counts = dict(kernels.launches)
    log(json.dumps({"gated_launch_counts": counts}))
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"gated step: non-finite metrics {vals}")
    if counts["masked_knn2"] != 1 or counts["masked_argmin_excl"] != 2:
        raise AssertionError("the gated step is not one K8 and two K9 "
                             "launches")
    log(f"gated step ({GATED}): loss {vals['loss']:.6f}, "
        f"{int(vals['num_pos_found'])} positives, labeler hit ratio "
        f"{vals['labeler_hit_ratio']:.4f}; K8 1 launch, K9 2")
    return counts


def known_answer(batch):
    """`label_pairs` at full size on a known answer: cloud 1 is phase 5's
    voxelized cloud 0 of each pair under a known pose, row for row, and
    both sides' labeler features are the same random unit vectors; for
    feature_filter "None" and "Lowe" (spatial_filter "None"), SC2-PCR
    recovers the pose (RTE < 0.05 m, RRE < 0.1 deg), the labeler's hit
    ratio is >= 0.99, and >= 99% of the rediscovered valid rows map to
    themselves and are kept."""
    import torch
    from eyoc_tpu_torch.geometry.metrics import rre_deg, rte
    from eyoc_tpu_torch.geometry.se3 import integrate_trans, transform_points
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import label_pairs
    vox, _ = preprocess_clouds(batch.xyz0, batch.n0, caps=CAPS,
                               voxel_size=0.3, window_bits=WINDOW_BITS)
    B, cap = vox.mask.shape
    yaw = 0.3
    R = torch.tensor([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    T = integrate_trans(R, torch.tensor([6.0, -2.5, 0.3])).cuda()
    T = T.expand(B, 4, 4).contiguous()
    x1 = transform_points(vox.xyz, T).contiguous()
    gen = torch.Generator().manual_seed(9)
    F = torch.nn.functional.normalize(torch.randn(B, cap, 32, generator=gen),
                                      dim=-1).cuda() * vox.mask[..., None]
    noise = torch.rand(B, cap, generator=gen).cuda()
    for ff in ("None", "Lowe"):
        lab = label_pairs(ext_config(feature_filter=ff, spatial_filter="None"),
                          F, vox.mask, vox.xyz, F, vox.mask, x1,
                          batch.frame_distance, T, noise)
        te, re = rte(lab.T_est, T), rre_deg(lab.T_est, T)
        sel_ok = torch.gather(vox.mask, 1, lab.pos_i.long())
        same = lab.ok & (lab.pos_j == lab.pos_i)
        share = float(same.sum()) / max(float(sel_ok.sum()), 1.0)
        hit = float(lab.labeler_hit.min())
        log(f"known answer, feature_filter {ff}: max RTE "
            f"{float(te.max()):.2e} m, max RRE {float(re.max()):.2e} deg, "
            f"min labeler hit {hit:.4f}, {share:.4f} of the "
            f"{int(sel_ok.sum())} rediscovered rows map to themselves, kept")
        if not (float(te.max()) < 0.05 and float(re.max()) < 0.1
                and hit >= 0.99 and share >= 0.99):
            raise AssertionError(f"label_pairs missed the known answer "
                                 f"({ff})")


# ------------------------------------------------------------------ phase 9


# the EYOC trainer through the train CLI: the KITTI launcher's flags
# (scripts/train_kitti_EYOC.sh:33-65) at phase 5's batch, width, lr and
# caps (the extension demo's capacity shrink 3.2: (16384, 5120, 1600, 500),
# experiments/extension_demo.py:90-91); cut to 3 epochs of one step (8
# pairs an epoch) over pair distances 1 -> 2 m, 2 validation pairs
TRAINER_EPOCHS = 3


def trainer_flags(out_dir: str) -> list:
    return [
        "--dataset", "SyntheticContinuousPairDataset",
        "--trainer", "ContinuousCorrExtensionTrainer",
        "--model", "ResUNetBN2C", "--model_n_out", "32",
        "--conv1_kernel_size", "5", "--optimizer", "SGD", "--lr", "0.1",
        "--batch_size", str(TRAIN_B), "--iter_size", "1",
        "--max_epoch", str(TRAINER_EPOCHS), "--voxel_size", "0.3",
        "--positive_pair_search_voxel_size_multiplier", "1.5",
        "--hit_ratio_thresh", "0.3", "--exp_gamma", "0.98",
        "--pair_min_dist", "1", "--pair_max_dist", "2",
        "--use_SC2_PCR", "true", "--extension_steps", "0",
        "--sync_strategy", "EMA", "--ema_decay", str(EXT_DECAY),
        "--feature_filter", "None", "--spatial_filter", "Similarity",
        "--filter_radius", "40", "--similarity_thresh", "0.6",
        "--use_sc2_filtering", "true", "--pretraining_dataset", "waymo",
        "--skip_initialization", "false",
        "--raw_point_capacity", str(RAW), "--voxel_capacity", str(CAPS[0]),
        "--level_capacity_shrink", "3.2",
        "--window_bits", ",".join(map(str, WINDOW_BITS)),
        "--val_max_iter", "2", "--stat_freq", "1", "--out_dir", out_dir]


# every kernel of the trainer's path: the train step's, the labeling's and
# the valid step's
TRAINER_KERNELS = TRAIN_KERNELS + ("sc2_power_iteration", "sc2_seed_topk",
                                   "sc2_nms", "sc2_seed_transforms",
                                   "sc2_irls", "est_quad_linear_robust")


def _same_state(a, b, what):
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    if set(sa) != set(sb) or not all(torch.equal(sa[k], sb[k]) for k in sb):
        raise AssertionError(f"resume: the {what} differs from the saved one")


def trainer_phase(smi):
    """Phase 9: `cli.train.main` in-process on the card with
    ContinuousCorrExtensionTrainer over SyntheticContinuousPairDataset
    (ResUNetBN2C, 32 outputs, voxel 0.3 m, B = 8 pairs of 131072 points an
    epoch, caps (16384, 5120, 1600, 500), SGD lr 0.1, the KITTI labeling,
    EMA 0.2). pair_min_dist 1 and pair_max_dist 2 over max_epoch 3 with
    extension_steps 0 (the schedule's interval 1): epoch 1 at MAX_DIST 1
    is base mode (identity labels, no labeler sync), epoch 2 extends to 2 m
    (the labeler's first sync, a copy, count 1) and epoch 3 stays there (an
    EMA sync, count 2); one step an epoch; after each a checkpoint and a
    validation of 2 pairs at 2 m, the best one written as
    best_val_checkpoint. Launch counts reset just before and read just
    after; every kernel of the path launched. Then a second `main` from
    `--resume_dir` (the CLI's get_config): it starts at epoch 4 (past
    max_epoch, so it trains nothing) with the student, the labeler, the
    optimizer state, num_updates and the generator equal to the first
    run's. Returns the first run's launch counts."""
    import os
    import shutil
    import tempfile
    import torch
    from eyoc_tpu_torch.cli.train import log_to_stdout, main
    from eyoc_tpu_torch.config import get_config
    from eyoc_tpu_torch.utils import kernels

    log_to_stdout()
    out = tempfile.mkdtemp(prefix="eyoc_trainer_")
    try:
        cfg = get_config(trainer_flags(out))
        cfg.update(synthetic_points=RAW, synthetic_pairs_per_epoch=TRAIN_B)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        tr = main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        log(json.dumps({"trainer_launch_counts": counts}))
        kinds = [e["kind"] for e in tr.epoch_log]
        if kinds != ["base", "extension", "extension"]:
            raise AssertionError(f"trainer epochs {kinds}, not a base epoch "
                                 "then two extension epochs")
        if tr.num_updates != 2 or not tr.labeler_initialized:
            raise AssertionError(f"labeler syncs: count {tr.num_updates}, "
                                 "not the first sync then one EMA")
        for e in tr.epoch_log:
            if not all(np.isfinite(v) for v in e["metrics"].values()):
                raise AssertionError(f"trainer epoch {e['epoch']}: "
                                     f"non-finite metrics {e['metrics']}")
        missing = [k for k in TRAINER_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"the trainer launched no {missing}")
        for name in ("checkpoint", "best_val_checkpoint"):
            for ext in (".pt", ".json"):
                if not os.path.exists(os.path.join(out, name + ext)):
                    raise AssertionError(f"no {name}{ext} written")
        with open(os.path.join(out, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        fmr = [r["value"] for r in scalars
               if r["tag"] == "val/feat_match_ratio"]
        if len(fmr) != TRAINER_EPOCHS:
            raise AssertionError(f"{len(fmr)} validations, not one an epoch")
        for e in tr.epoch_log:
            m = ", ".join(f"{k} {v:.4f}" for k, v in e["metrics"].items())
            log(f"trainer epoch {e['epoch']} ({e['kind']}, {e['steps']} "
                f"step): Data {e['data_s'] * 1e3:.1f} ms/step, Iter "
                f"{e['iter_s'] * 1e3:.1f} ms/step (the trainer's Timers: "
                f"Iter includes Data, the prefetch thread's raycast of "
                f"{TRAIN_B} scenes), Iter - Data "
                f"{(e['iter_s'] - e['data_s']) * 1e3:.1f} ms; {m}")
        base = [e["iter_s"] for e in tr.epoch_log if e["kind"] == "base"]
        ext = [e["iter_s"] for e in tr.epoch_log if e["kind"] == "extension"]
        log(f"trainer: train {np.mean(base) * 1e3:.1f} ms/step, extension "
            f"{np.mean(ext) * 1e3:.1f} ms/step (Iter as logged), validation "
            f"feat_match_ratio {fmr} (best {tr.best_val} at epoch "
            f"{tr.best_val_epoch}), {wall:.1f} s for main() on {smi}")

        r = main(get_config(["--resume_dir", out]))
        torch.cuda.synchronize()
        if r.start_epoch != TRAINER_EPOCHS + 1 or r.epoch_log:
            raise AssertionError(f"resume starts at epoch {r.start_epoch}")
        if r.num_updates != tr.num_updates or (r.best_val, r.best_val_epoch) \
                != (tr.best_val, tr.best_val_epoch):
            raise AssertionError("resume: num_updates or best_val differ")
        if not torch.equal(r.generator.get_state(), tr.generator.get_state()):
            raise AssertionError("resume: the generator state differs")
        _same_state(r.model, tr.model, "student")
        _same_state(r.labeler, tr.labeler, "labeler")
        oa, ob = r.opt.state_dict(), tr.opt.state_dict()
        if oa["param_groups"] != ob["param_groups"] or set(oa["state"]) != \
                set(ob["state"]) or not all(
                    torch.equal(oa["state"][i][k], v)
                    for i, st in ob["state"].items() for k, v in st.items()):
            raise AssertionError("resume: the optimizer state differs")
        log(f"trainer resume: epoch {r.start_epoch}, the student, labeler, "
            f"optimizer state ({len(ob['state'])} momentum buffers), "
            f"num_updates {r.num_updates} and generator equal to the saved "
            "ones")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return counts


def optimizer_and_loss_steps(batch, tcfg):
    """Phase 9, on phase 5's batch and recipe (a fresh ResUNetBN2C): one
    base_train_step at iter_size 2 (two micro-batches, each the batch),
    one with Adam and one with AdamW (lr 1e-3, torch's default; SGD's
    steps lr 0.1), then one of each other loss kind
    (contrastive, triplet, hardest triplet; triplet_num_pos 256 and
    triplet_num_rand 1024 a pair, the flags' defaults), each with finite
    metrics and positives, its K2 and K6 calls recorded and held to their
    plain versions (`check_calls`). Returns (the kernels line's rows for
    the new call shapes, their launches): `masked_argmin_triplet` (the
    hardest-triplet step's K2 calls: the GT pairs, and the mining at
    2048 x 2048 x 32), `take_rows_losses` and `take_rows_backward_losses`
    (the three loss steps' K6 calls)."""
    import dataclasses
    import torch
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.ops import rows
    from eyoc_tpu_torch.training import loss, pipeline
    from eyoc_tpu_torch.training.optim import adam, adamw, sgd
    from eyoc_tpu_torch.training.steps import base_train_step
    from eyoc_tpu_torch.utils import kernels

    model = init_unet(load_model("ResUNetBN2C"),
                      torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    gen = torch.Generator().manual_seed(9)
    trip = dict(triplet_num_pos=256 * TRAIN_B,
                triplet_num_rand=1024 * TRAIN_B)
    steps = [("iter_size 2", dataclasses.replace(tcfg, iter_size=2), sgd,
              0.1, [batch, batch]),
             ("Adam", tcfg, adam, 1e-3, batch),
             ("AdamW", tcfg, adamw, 1e-3, batch)]
    steps += [(kind, dataclasses.replace(tcfg, loss_kind=kind, **trip), sgd,
               0.1, batch) for kind in ("contrastive", "triplet",
                                        "hardest_triplet")]
    sites = [(rows, "take_rows_gather"), (rows, "take_rows_backward"),
             (pipeline, "masked_argmin_batched"), (loss, "masked_argmin")]
    calls, counts = {}, {}
    for name, cfg, make_opt, lr, b in steps:
        opt = make_opt(model.parameters(), lr=lr, weight_decay=1e-4)
        torch.cuda.synchronize()
        kernels.reset_counts()
        with recording(sites) as got:
            m = base_train_step(model, opt, b, cfg, generator=gen,
                                device="cuda")
        torch.cuda.synchronize()
        counts[name] = dict(kernels.launches)
        calls[name] = got
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()) or \
                vals["num_pos_found"] <= 0:
            raise AssertionError(f"the {name} step: metrics {vals}")
        log(f"{name} step: " + ", ".join(f"{k} {v:.6f}"
                                         for k, v in vals.items())
            + "; launches " + ", ".join(
                f"{k} {counts[name][k]}" for k in ("masked_argmin",
                                                   "take_rows",
                                                   "take_rows_backward")))
    if counts["hardest_triplet"]["masked_argmin"] != 3:
        raise AssertionError("the hardest-triplet step is not 3 K2 launches "
                             "(the GT pairs, two minings)")

    def cat(names, site):
        return [c for n in names for c in calls[n][site]]

    plain_group = ("iter_size 2", "Adam", "AdamW", "contrastive", "triplet")
    losses = ("contrastive", "triplet", "hardest_triplet")
    check_calls("K2 masked_argmin, the iter_size 2, Adam, AdamW, contrastive "
                "and triplet steps",
                cat(plain_group, "masked_argmin_batched")
                + cat(plain_group, "masked_argmin"), _k2, _k2_plain,
                _argmin_cost, _argmin_close, classify=_argmin_class)
    optim_group = plain_group[:3]
    check_calls("K6 take_rows, the iter_size 2, Adam and AdamW steps",
                cat(optim_group, "take_rows_gather"), rows.take_rows_gather,
                rows.take_rows_plain, _gather_cost, _gather_close,
                _index_select, reps=SMALL_REPS)
    check_calls("K6 take_rows_backward, the iter_size 2, Adam and AdamW "
                "steps", cat(optim_group, "take_rows_backward"),
                rows.take_rows_backward, rows.take_rows_backward_plain,
                _scatter_cost, _scatter_close, _index_add, reps=SMALL_REPS)
    (q, _, r, _), _ = calls["hardest_triplet"]["masked_argmin"][0]
    out = {"masked_argmin_triplet": check_calls(
        "K2 masked_argmin, one hardest-triplet step (GT pairs in one "
        f"batched call, 2 minings at {q.shape[0]} x {r.shape[0]} x "
        f"{q.shape[1]})",
        cat(("hardest_triplet",), "masked_argmin_batched")
        + cat(("hardest_triplet",), "masked_argmin"), _k2, _k2_plain,
        _argmin_cost, _argmin_close, classify=_argmin_class)}
    out["take_rows_losses"] = check_calls(
        "K6 take_rows, the contrastive, triplet and hardest-triplet steps",
        cat(losses, "take_rows_gather"), rows.take_rows_gather,
        rows.take_rows_plain, _gather_cost, _gather_close, _index_select,
        reps=SMALL_REPS)
    out["take_rows_backward_losses"] = check_calls(
        "K6 take_rows_backward, the contrastive, triplet and hardest-triplet "
        "steps", cat(losses, "take_rows_backward"), rows.take_rows_backward,
        rows.take_rows_backward_plain, _scatter_cost, _scatter_close,
        _index_add, reps=SMALL_REPS)
    launches = {
        "masked_argmin_triplet": counts["hardest_triplet"]["masked_argmin"],
        "take_rows_losses": sum(counts[n]["take_rows"] for n in losses),
        "take_rows_backward_losses": sum(counts[n]["take_rows_backward"]
                                         for n in losses)}
    return out, launches


# ----------------------------------------------------------------- phase 11


WIDTHS = (16, 33, 64, 200)  # feature widths other than the models' 3, 32
WIDTH_N = 4096            # K2's and K9's rows, K8's per problem


def _unit(gen, *shape):
    import torch
    x = torch.randn(*shape, generator=gen)
    return torch.nn.functional.normalize(x, dim=-1).cuda()


def width_phase():
    """Feature widths other than 3 and 32 (a checkpoint at another
    --model_n_out, FPFH's 33): K2, K8 and K9 at D = 16, 33, 64 and 200 (the
    wrappers pad with zero columns to the kernels' instances 32, 64 and
    256)
    against their plain versions at the real width, at K2's, K8's and K9's
    tolerances (indices equal past K2_GAP), one launch a call; D = 32 the
    bits of a call on the features padded from 16 to 32 by hand; K1 at an
    output width of 20 (the padded route), in the eval form and through
    autograd (dx and dW of the real columns), against its plain version.
    Returns {(kernel, D): row}, logged, for PERF.md."""
    import torch
    from eyoc_tpu_torch.ops import knn
    from eyoc_tpu_torch.sparse import brick_conv as bc
    from eyoc_tpu_torch.utils import kernels
    gen = torch.Generator().manual_seed(33)
    rows = {}
    for D in WIDTHS:
        n = WIDTH_N
        q, r = _unit(gen, n, D), _unit(gen, n, D)
        qm = (torch.rand(n, generator=gen) < 0.9).cuda()
        rm = (torch.rand(n, generator=gen) < 0.9).cuda()
        for name, fn, plain, cost, close, args in (
                ("masked_argmin", knn.masked_argmin, knn.masked_argmin_plain,
                 _argmin_cost, _argmin_close, (q, qm, r, rm)),
                ("masked_knn2", knn.masked_knn_batched,
                 knn.masked_knn_batched_plain, _knn2_cost, _knn2_close,
                 (q[None], qm[None], r[None], rm[None], 2)),
                ("masked_argmin_excl", knn.masked_argmin_excl,
                 knn.masked_argmin_excl_plain, _excl_cost, _excl_close,
                 (q[:n // 2], r[:n // 2],
                  (torch.rand(n // 2, 3, generator=gen) * 20).cuda(),
                  (torch.rand(n // 2, 3, generator=gen) * 20).cuda(),
                  1.5 ** 2))):
            label = f"{name} at D = {D} (padded to " \
                + (f"{knn.k2_width(D)})" if name == "masked_argmin"
                   else f"{knn.knn_width(D)})")
            rows[(name, D)] = check_calls(label, [(args, {})], fn, plain,
                                          cost, close, reps=10)
            before = kernels.launches[name]
            fn(*args)
            if kernels.launches[name] - before != 1:
                raise AssertionError(f"{label}: not one launch a call")
    # D = 32: the features padded from 16 by hand give the padded call's
    # bits (the wrapper's copy is that padding)
    q, r = _unit(gen, WIDTH_N, 16), _unit(gen, WIDTH_N, 16)
    qm = torch.ones(WIDTH_N, dtype=torch.bool, device="cuda")
    for name, fn in (("masked_argmin", knn.masked_argmin),
                     ("masked_knn2", lambda *a: knn.masked_knn(*a, k=2))):
        a = fn(q, qm, r, qm)
        b = fn(knn.pad_features(q, 32), qm, knn.pad_features(r, 32), qm)
        if not all(bool(torch.equal(x, y)) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: D = 16 padded by the wrapper and "
                                 "by hand differ")
    # K1 at 20 output channels: the eval form and autograd
    m_in, m_out, taps, ci, co = 20000, 16000, 27, 32, 20
    x = torch.randn(m_in, ci, generator=gen).cuda().to(torch.bfloat16)
    W = (torch.randn(taps, ci, co, generator=gen) * 0.1).cuda()
    nmap = torch.stack([torch.randperm(m_in, generator=gen)[:m_out]
                        for _ in range(taps)], 1).to(torch.int32)
    nmap[torch.rand(m_out, taps, generator=gen) < 0.3] = m_in
    nmap = nmap.cuda()
    bias = torch.randn(co, generator=gen).cuda()
    mask = (torch.rand(m_out, generator=gen) < 0.8).cuda()
    Wb = W.to(torch.bfloat16)
    label = "K1 sparse_conv at 20 output channels (padded to 24)"
    rows[("sparse_conv", co)] = check_calls(
        label, [((x, Wb, nmap), dict(bias=bias, mask=mask, relu=True))],
        bc.sparse_conv, bc.sparse_conv_plain, _conv_cost,
        _bf16_close(K1_RTOL, K1_ATOL_FRAC), reps=10)
    inv = bc.invert_map(nmap, m_in)
    wts = torch.randn(m_out, co, generator=gen).cuda()
    outs = []
    for f, xx in ((bc.sparse_conv_diff, x), (None, x.float())):
        xg = xx.clone().requires_grad_()
        Wg = W.clone().requires_grad_()
        if f is None:
            out = bc.sparse_conv_plain(xg, Wg, nmap)
        else:
            out = f(xg, None, Wg, nmap, inv)
        (out.float() * wts).sum().backward()
        outs.append((out.detach().float(), xg.grad.float(), Wg.grad))
    for (got, want), what in zip(zip(outs[0], outs[1]), ("y", "dx", "dW")):
        ok, err = _bf16_close(K1_RTOL, K1_ATOL_FRAC)(got, want)
        if not ok:
            raise AssertionError(f"{label}, autograd: {what} disagrees with "
                                 f"the plain version: max err {err}")
        log(f"  {label}, autograd: {what} max abs err {err:.3e}")
    log("width rows: " + json.dumps({
        f"{k[0]}@{k[1]}": {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                             "bound_ms", "max_abs_err")}
        for k, v in rows.items()}))
    return rows


# ----------------------------------------------------------------- phase 10


# the runbook's KITTI-format tree: frames of one drive along a straight
# road (m a frame), and the pairs of each cli.test run
RUNBOOK_FRAMES = 12
RUNBOOK_STEP = 2.0
RUNBOOK_PAIRS = 4
# the eval kernels each cli.test run must launch, by estimator
RUNBOOK_KERNELS = {
    "RANSAC": COORD_KERNELS + ("sparse_conv", "masked_argmin",
                               "ransac_hypotheses_topk", "ransac_verify",
                               "ransac_polish"),
    "SC2-PCR": COORD_KERNELS + ("sparse_conv", "masked_argmin",
                                "sc2_power_iteration", "sc2_nms",
                                "sc2_seed_topk", "sc2_seed_transforms",
                                "sc2_irls"),
}


def reference_checkpoint(path):
    """A reference-style best_val_checkpoint.pth of ResUNetBN2C/32 (conv1
    k = 5): the port's init (torch.Generator seed 7) through the port's
    exporter, in the reference's container (lib/trainer.py:166-179)."""
    import torch
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.tools.import_torch_ckpt import (
        params_to_torch_state_dict)
    model = init_unet(load_model("ResUNetBN2C"),
                      torch.Generator().manual_seed(7), 1, 32, 5,
                      dtype=torch.float32, device="cpu")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          params_to_torch_state_dict(model.state_dict()).items()}
    torch.save({"epoch": 0, "state_dict": sd, "optimizer": {},
                "scheduler": {}, "config": {
                    "model": "ResUNetBN2C", "model_n_out": 32,
                    "conv1_kernel_size": 5, "voxel_size": 0.3},
                "best_val": 0.0, "best_val_epoch": 0,
                "best_val_metric": "feat_match_ratio"}, path)


def runbook_tree(root, drive):
    """A KITTI odometry tree under <root>/dataset/sequences/%02d: the port's
    synthetic raycast scans (HDL-64E-like, 64 x 2048 rays, float32 xyzr
    .bin) of one scene from RUNBOOK_FRAMES sensor poses RUNBOOK_STEP apart
    along x; calib.txt's Tr the legacy reader's velo-to-cam (so that the
    N-frame readers' Tr conjugation and KITTINMPairDataset's hardcoded one
    give the same velodyne poses), poses.txt the camera poses Tr S Tr^-1
    of the sensor poses S. Returns the host seconds it took."""
    import os
    from eyoc_tpu_torch.data.datasets import _velo2cam
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs
    t0 = time.perf_counter()
    seq = os.path.join(root, "dataset", "sequences", "%02d" % drive)
    os.makedirs(os.path.join(seq, "velodyne"))
    tr = _velo2cam().T                        # velodyne -> camera
    rng = np.random.default_rng(10)
    span = RUNBOOK_STEP * (RUNBOOK_FRAMES - 1)
    sites = tuple((RUNBOOK_STEP * t, 0.0) for t in range(RUNBOOK_FRAMES))
    scene = SyntheticPairs.make_scene(rng, span, keepout=sites)

    def row(T):
        return " ".join(f"{v:.12e}" for v in T[:3].reshape(-1))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: {row(np.eye(4))}\n")
        f.write(f"Tr: {row(tr)}\n")
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        for t, (x, y) in enumerate(sites):
            S = np.eye(4)
            S[:3, 3] = (x, y, 0.0)
            f.write(row(tr @ S @ np.linalg.inv(tr)) + "\n")
            pts = SyntheticPairs.raycast_scan(rng, (x, y, 0.0), 0.0, scene,
                                              n_az=RAW // 64,
                                              terrain_seed=6000)
            if len(pts) > RAW:
                pts = pts[rng.permutation(len(pts))[:RAW]]
            xyzr = np.concatenate([pts, np.full((len(pts), 1), 0.5,
                                                np.float32)], 1)
            xyzr.astype(np.float32).tofile(
                os.path.join(seq, "velodyne", "%06d.bin" % t))
    return time.perf_counter() - t0


def runbook_phase(smi, work):
    """Phase 10, the real-data runbook (README.md) through the port on the
    card, in the directory `work` (phase 13 reads its tree and checkpoint
    again; the caller removes it): a reference-style checkpoint
    (`reference_checkpoint`) imported by
    `tools.import_torch_ckpt.main(... --write_test_config)`; a KITTI-format
    tree (`runbook_tree`: one drive of the test split); `cli.test.main`
    over it on KITTINMPairDataset (its ICP ground truth on the card), once
    with RANSAC (the CLI's default) and once with `--use_RANSAC false`
    (SC2-PCR), RUNBOOK_PAIRS pairs each: the eval kernels launched (counts
    reset just before `main`, read just after), rr / rte / rre /
    pairs_per_sec and the Data / Feat / Reg times printed, each pair's pose
    the bits of `eval.test_pair` on the same batch and draws, and RR the
    mean of `registration_success` on those poses (RR is not asserted:
    the weights are random). Returns ({estimator: the run's result},
    {"checkpoint", "kitti_root", "split"}: the imported checkpoint's path
    base, the tree's root and the one-drive split file)."""
    import dataclasses
    import os

    import torch
    from eyoc_tpu_torch.cli import test as cli_test
    from eyoc_tpu_torch.data import datasets
    from eyoc_tpu_torch.eval import test_pair
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.tools import import_torch_ckpt
    from eyoc_tpu_torch.training.checkpoint import load_weights_only
    from eyoc_tpu_torch.training.trainer import build_step_config
    from eyoc_tpu_torch.utils import kernels

    split_file = datasets._split_file
    try:
        pth = os.path.join(work, "best_val_checkpoint.pth")
        reference_checkpoint(pth)
        out = os.path.join(work, "imported")
        import_torch_ckpt.main(["--input", pth, "--output_dir", out,
                                "--name", "best_val_checkpoint",
                                "--write_test_config"])
        with open(split_file("test_kitti.txt")) as f:
            drive = int(f.read().split()[0])
        root = os.path.join(work, "kitti")
        secs = runbook_tree(root, drive)
        log(f"runbook: a KITTI-format tree, drive {drive:02d} of the test "
            f"split, {RUNBOOK_FRAMES} raycast scans of <= {RAW} points, "
            f"{secs:.1f} s on the host")
        one = os.path.join(work, "split.txt")
        with open(one, "w") as f:
            f.write(f"{drive:02d}\n")
        datasets._split_file = lambda name: one
        spec = load_model("ResUNetBN2C")
        model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                          device="cuda")
        load_weights_only(os.path.join(out, "best_val_checkpoint"), model)
        results = {}
        for est, flag in (("RANSAC", "true"), ("SC2-PCR", "false")):
            args = cli_test.parse_args([
                "--save_dir", out, "--kitti_root", root, "--dataset",
                "KITTINMPairDataset", "--use_RANSAC", flag, "--num_pairs",
                str(RUNBOOK_PAIRS)])
            config = cli_test.load_test_config(args)
            record = []
            torch.cuda.synchronize()
            kernels.reset_counts()
            res = cli_test.main(config, num_pairs=args.num_pairs,
                                record=record)
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            missing = [k for k in RUNBOOK_KERNELS[est] if counts[k] <= 0]
            if missing or len(record) != RUNBOOK_PAIRS:
                raise AssertionError(f"cli.test ({est}): {len(record)} pairs,"
                                     f" launched no {missing}")
            _, cfg = build_step_config(config, spec)
            cfg = dataclasses.replace(cfg, use_ransac=bool(config.use_RANSAC))
            ok = []
            for batch, state, T_est in record:
                gen = torch.Generator(device="cuda")
                gen.set_state(state)
                want = test_pair(model, batch, cfg, generator=gen)["T_est"]
                if not torch.equal(want, T_est):
                    raise AssertionError(
                        f"cli.test ({est}): a pose differs from "
                        f"eval.test_pair's on the same batch and draws by "
                        f"{float((want - T_est).abs().max())}")
                ok.append(bool(registration_success(
                    T_est, batch.T_gt[0], config.rte_thresh,
                    config.rre_thresh)[0]))
            if res["rr"] != float(np.mean(ok)):
                raise AssertionError(f"cli.test ({est}): RR {res['rr']} is "
                                     "not the mean of registration_success "
                                     f"on its poses ({ok})")
            results[est] = res
            log(f"runbook, cli.test with {est}: {RUNBOOK_PAIRS} pairs of "
                f"ResUNetBN2C (imported, random weights) on "
                f"KITTINMPairDataset: rr {res['rr']:.4f}, rte "
                f"{res['rte']:.4f} m, rre {res['rre']:.4f} deg, "
                f"pairs_per_sec {res['pairs_per_sec']:.3f}; Data "
                f"{res['data_time'] * 1e3:.2f} ms, Feat "
                f"{res['feat_time'] * 1e3:.2f} ms, Reg "
                f"{res['reg_time'] * 1e3:.2f} ms a pair (host clock around "
                f"synchronized calls; the Data time carries the reader's ICP "
                f"ground truth of each pair that no run before cached); "
                f"each pose the bits of eval.test_pair on the same batch "
                f"and draws; launches "
                + json.dumps({k: v for k, v in counts.items() if v})
                + f"; on {smi}")
        return results, {"checkpoint": os.path.join(
            out, "best_val_checkpoint"), "kitti_root": root, "split": one}
    finally:
        datasets._split_file = split_file


# ------------------------------------------------------------------- main


# ----------------------------------------------------------------- phase 12


EXP_REPEAT_NORMS = 7       # ResUNetExpBN2C's repeat norms a cloud
PACKED_CI = (3, 6)         # extract_features' input widths: rgb, + normals


def train_sites():
    """The training kernels' wrappers (record_train_step's sites)."""
    from eyoc_tpu_torch.ops import rows
    from eyoc_tpu_torch.sparse import brick_conv, norm
    from eyoc_tpu_torch.training import loss, pipeline
    return [(brick_conv, "sparse_conv"), (brick_conv, "sparse_conv_dgrad"),
            (brick_conv, "sparse_conv_wgrad"), (rows, "take_rows_gather"),
            (rows, "take_rows_backward"), (norm, "masked_channel_sums"),
            (norm, "masked_norm_apply"), (norm, "masked_norm_backward"),
            (pipeline, "masked_argmin_batched"), (loss, "masked_argmin")]


def calls_bound(calls) -> float:
    """The sum of the bounds of the recorded kernel calls (K1, K1's dgrad,
    K5, K6, K7, K21, K22, K2): a floor under the path that ran them, which
    leaves out the coordinate kernels and the torch ops between."""
    costs = {"sparse_conv": _conv_cost, "sparse_conv_dgrad": _conv_cost,
             "sparse_conv_wgrad": _wgrad_cost,
             "take_rows_gather": _gather_cost,
             "take_rows_backward": _scatter_cost,
             "masked_channel_sums": _sums_cost,
             "masked_norm_apply": _k22_cost,
             "masked_norm_backward": _k21_cost,
             "masked_argmin_batched": _argmin_cost,
             "masked_argmin": _argmin_cost}
    total = 0.0
    for name, cl in calls.items():
        for a, k in cl:
            nbytes, ops, kind, *_ = costs[name](*a, **k)
            total += bound_ms(nbytes, ops, kind)[0]
    return total


def _moved_statistics(model, seed):
    """Every BatchNorm's running statistics drawn off (0, 1) (mean N(0,
    0.1), var in [0.5, 1.5]): the eval norms then move every value."""
    import torch
    from eyoc_tpu_torch.models.unet import BatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.shape
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    model.eval()                 # the folded weights are made again


def _eval_pairs(model, pairs, cfg, what, unit=True):
    """embed_pair + register_pair on each pair, synchronized; the poses
    finite, the features zero at invalid voxels (and unit-norm at the
    valid ones when `unit`). Returns (feat ms, reg ms) a pair."""
    import torch
    from eyoc_tpu_torch.eval import embed_pair, register_pair
    noise_gen = torch.Generator().manual_seed(1)
    feat, reg = [], []
    for batch in pairs:
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0, f0, m0, x1, f1, m1 = embed_pair(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T = register_pair(x0, f0, m0, x1, f1, m1, cfg, generator=noise_gen)
        torch.cuda.synchronize()
        feat.append((t1 - t0) * 1e3)
        reg.append((time.perf_counter() - t1) * 1e3)
        if not bool(torch.isfinite(T).all()):
            raise AssertionError(f"{what}: non-finite T_est {T}")
        for f, m in ((f0, m0), (f1, m1)):
            if not bool(torch.isfinite(f).all()) or bool((f[~m] != 0).any()):
                raise AssertionError(f"{what}: features not finite or not 0 "
                                     "at invalid voxels")
            norms = f[m].norm(dim=1)
            if unit and float((norms - 1).abs().max()) > 1e-3:
                raise AssertionError(f"{what}: features are not unit-norm")
    return float(np.mean(feat)), float(np.mean(reg))


def _one_step(model, opt, batch, cfg, seed, what, step=None):
    """One train step (`step`, default base_train_step) with the counts
    reset just before; finite metrics, finite grads. Returns (metrics,
    counts, host ms)."""
    import torch
    from eyoc_tpu_torch.training.steps import base_train_step
    from eyoc_tpu_torch.utils import kernels
    step = step or base_train_step
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    m = step(model, opt, batch, cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)
    vals = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{what}: non-finite metrics {vals}")
    if any(p.grad is None or not bool(torch.isfinite(p.grad).all())
           for p in model.parameters()):
        raise AssertionError(f"{what}: a parameter has no or a non-finite "
                             "grad")
    return m, counts, ms


def expbn2c_phase(pairs, train_batch, tcfg, cfg, smi):
    """ResUNetExpBN2C at eval (K22 from the running statistics, checked on
    one forward's calls; the 4 pairs counted) and one train step. Returns
    ({row: kernels-line row}, {row: launches})."""
    import torch
    from eyoc_tpu_torch.eval import embed_pair
    from eyoc_tpu_torch.models import init_unet, load_model, unet
    from eyoc_tpu_torch.sparse import norm
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.utils import kernels
    spec = load_model("ResUNetExpBN2C")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    _moved_statistics(model, 24)
    b0 = pairs[0].to("cuda")
    with recording([(unet, "masked_norm_apply"),
                    (unet, "sparse_conv")]) as calls:
        embed_pair(model, b0, cfg)
    torch.cuda.synchronize()
    k22 = calls["masked_norm_apply"]
    if len(k22) != 2 * EXP_REPEAT_NORMS:
        raise AssertionError(f"ResUNetExpBN2C: {len(k22)} K22 calls a pair, "
                             f"not {2 * EXP_REPEAT_NORMS}")
    label = ("K22 masked_norm_apply, ResUNetExpBN2C's eval forward (the "
             "repeat norms, running statistics)")
    row = check_calls(label, k22, norm.masked_norm_apply,
                      norm.masked_norm_apply_plain, _k22_cost, _k22_close,
                      reps=SMALL_REPS // 4, classify=_k22_class)
    log(f"  {label}: library: none: F.batch_norm counts the padding rows")
    same_bits_twice(label, norm.masked_norm_apply, k22)
    a, k = k22[0]
    kernels_per_call(label, lambda: norm.masked_norm_apply(*a, **k))
    pair_bound = calls_bound(calls)
    feat_dev = device_ms([lambda: embed_pair(model, b0, cfg)], 5)

    _eval_pairs(model, pairs[:1], cfg, "ResUNetExpBN2C")      # warm-up
    kernels.reset_counts()
    feat, reg = _eval_pairs(model, pairs, cfg, "ResUNetExpBN2C")
    counts = dict(kernels.launches)
    log(json.dumps({"expbn2c_eval_launch_counts": counts}))
    if counts["masked_norm_apply"] != 2 * EXP_REPEAT_NORMS * N_PAIRS \
            or counts["masked_channel_sums"] or counts["sparse_conv"] <= 0 \
            or counts["masked_instance_norm"]:
        raise AssertionError("ResUNetExpBN2C's eval path is not 7 K22 "
                             "launches a cloud, no K7, no K20")
    log(f"ResUNetExpBN2C eval: {N_PAIRS} pairs, feat {feat:.2f} ms/pair "
        f"(device {fmt_ms(feat_dev)} a pair's features; its K1 and K22 "
        f"calls' bounds {pair_bound:.4f} ms), reg {reg:.2f} ms/pair, on "
        f"{smi}")

    opt = sgd(model.parameters(), lr=0.1, momentum=0.8, weight_decay=1e-4)
    _one_step(model, opt, train_batch, tcfg, 2, "ResUNetExpBN2C warm-up")
    with recording(train_sites()) as step_calls:
        m, c, ms = _one_step(model, opt, train_batch, tcfg, 3,
                             "ResUNetExpBN2C train step")
    missing = [k for k in TRAIN_KERNELS if c[k] <= 0]
    if missing:
        raise AssertionError(f"ResUNetExpBN2C train step launched no "
                             f"{missing}")
    n_bn = norm_counts(model)[1]
    if n_bn != 42:               # 7 top-level, 28 in blocks, 7 repeats
        raise AssertionError(f"ResUNetExpBN2C: {n_bn} batch norms, not 42")
    norm_launches(c, "ResUNetExpBN2C train step", 0, n_bn, 1)
    more = [_one_step(model, opt, train_batch, tcfg, 4 + i,
                      "ResUNetExpBN2C train step")[2] for i in range(2)]
    log(f"ResUNetExpBN2C train step, B={TRAIN_B}: loss "
        f"{float(m['loss']):.6f}, {ms:.2f} ms recorded, then "
        + ", ".join(f"{t:.2f}" for t in more) + " ms (host clock, "
        f"synchronized; its kernels' bounds {calls_bound(step_calls):.4f} "
        f"ms), on {smi}")
    return {"masked_norm_apply_eval": row}, \
        {"masked_norm_apply_eval": counts["masked_norm_apply"]}


def extract_phase(pairs, smi):
    """api.extract_features with rgb (Ci = 3) and with rgb and normals
    (Ci = 6) on pair 0's cloud 0, counts reset just before each: the first
    conv on K1's packed route, checked against its plain version."""
    import torch
    from eyoc_tpu_torch import api
    from eyoc_tpu_torch.models import init_unet, load_model, unet
    from eyoc_tpu_torch.sparse import brick_conv as bc
    from eyoc_tpu_torch.utils import kernels
    b0 = pairs[0]
    n = int(b0.n0[0])
    xyz = b0.xyz0[0, :n].numpy()
    rng = np.random.default_rng(12)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    spec = load_model("ResUNetBN2C")
    rows, launches = {}, {}
    for cin, kw in ((3, dict(rgb=rgb)), (6, dict(rgb=rgb, normal=nrm))):
        model = init_unet(spec, torch.Generator().manual_seed(cin), cin, 32,
                          5, device="cuda")
        _moved_statistics(model, 40 + cin)
        args = dict(voxel_size=0.3, caps=CAPS, window_bits=WINDOW_BITS, **kw)
        api.extract_features(model, xyz, **args)             # warm-up
        torch.cuda.synchronize()
        kernels.reset_counts()
        with recording([(unet, "sparse_conv")]) as calls:
            t0 = time.perf_counter()
            pts, f = api.extract_features(model, xyz, **args)
            ms = (time.perf_counter() - t0) * 1e3
        name = f"sparse_conv_ci{cin}"
        launches[name] = kernels.launches["sparse_conv"]
        if pts.shape[0] != f.shape[0] or f.shape[1] != 32 or \
                not np.isfinite(f).all() or \
                np.abs(np.linalg.norm(f, axis=1) - 1).max() > 1e-3:
            raise AssertionError(f"extract_features, Ci = {cin}: shapes "
                                 f"{pts.shape} / {f.shape}, or features not "
                                 "finite and unit-norm")
        packed = [(a, k) for a, k in calls["sparse_conv"]
                  if a[0].shape[1] == cin]
        (x, W, nmap), _ = packed[0]
        plan = bc.k1_plan(nmap.shape[0], W.shape[0], cin, 0, W.shape[2])
        if len(packed) != 1 or not plan.packed:
            raise AssertionError(f"extract_features, Ci = {cin}: the first "
                                 "conv is not one call on the packed route")
        label = (f"K1 sparse_conv, the packed route at Ci = {cin} (K = "
                 f"{W.shape[0] * cin}; extract_features' first conv)")
        rows[name] = check_calls(label, packed, bc.sparse_conv,
                                 bc.sparse_conv_plain, _conv_cost,
                                 _bf16_close(K1_RTOL, K1_ATOL_FRAC), reps=10)
        same_bits_twice(label, bc.sparse_conv, packed)
        log(f"extract_features, Ci = {cin}: {pts.shape[0]} voxels of {n} "
            f"points, {ms:.2f} ms (host clock, with the copies to the "
            f"host), {launches[name]} K1 launches, on {smi}")
    return rows, launches


def _gap_scaled(close, feats):
    """`close` (_argmin_close or _knn2_close) with K2_GAP scaled by the
    largest squared norm of the features (queries and refs) it holds: the
    distances and their rounding scale with |f|^2 (K2_GAP at unit
    features)."""
    def scaled(got, want, q, qm, r, *rest, **kw):
        s2 = max(1.0, float((q.float() ** 2).sum(-1).max()),
                 float((r.float() ** 2).sum(-1).max()))
        feats.append(s2)
        return close(got, want, q, qm, r, *rest, gap=K2_GAP * s2, **kw)
    return scaled


def unnormalized_phase(pairs, train_batch, tcfg, smi):
    """normalize_feature=False: one eval pair (the SC2-PCR estimator's K2
    on the raw features), one train step (K2's mining on them) and one
    extension step at the demo's gates (K8 on the labeler's raw features),
    counts reset before each; K2 and K8 held to their plain versions with
    the gap scaled to the features' squared norm."""
    import dataclasses

    import torch
    from eyoc_tpu_torch.eval import EvalConfig
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.ops import knn, matching
    from eyoc_tpu_torch.registration import sc2pcr
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
    from eyoc_tpu_torch.training import loss
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.steps import extension_train_step
    from eyoc_tpu_torch.utils import kernels
    spec = load_model("ResUNetBN2C")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda", normalize_feature=False)
    cfg = EvalConfig(caps=CAPS, voxel_size=0.3, window_bits=WINDOW_BITS,
                     eval_sample_points=N_CORR,
                     sc2=SC2PCRConfig(max_points=N_CORR, seed_cap=N_SEEDS))
    _eval_pairs(model, pairs[1:2], cfg, "raw features", unit=False)
    with recording([(sc2pcr, "masked_argmin")]) as eval_calls:
        kernels.reset_counts()
        _eval_pairs(model, pairs[1:2], cfg, "raw features", unit=False)
        k2_eval = kernels.launches["masked_argmin"]
    raw_cfg = dataclasses.replace(tcfg, normalize_feature=False)
    opt = sgd(model.parameters(), lr=0.1, momentum=0.8, weight_decay=1e-4)
    with recording([(loss, "masked_argmin")]) as step_calls:
        m, c, ms = _one_step(model, opt, train_batch, raw_cfg, 6,
                             "train step, raw features")
    log(f"train step, normalize_feature=False: loss {float(m['loss']):.6f},"
        f" {ms:.2f} ms")
    k2 = eval_calls["masked_argmin"] + step_calls["masked_argmin"]
    feats = []
    rows = {"masked_argmin_raw": check_calls(
        "K2 masked_argmin on raw features (the eval pair's feature 1-NN, "
        "the step's mining)", k2, _k2, _k2_plain, _argmin_cost,
        _gap_scaled(_argmin_close, feats), classify=_argmin_class)}
    log(f"  the features' largest squared norm {max(feats):.4g} (the gap "
        f"{K2_GAP * max(feats):.4g})")
    launches = {"masked_argmin_raw": k2_eval + c["masked_argmin"]}

    student, labeler, ext_opt, _ = ext_models(spec)
    ext_cfg = ext_config(**GATED, normalize_feature=False)
    with recording([(matching, "masked_knn_batched")]) as knn_calls:
        m, c, ms = _one_step(
            student, ext_opt, train_batch, ext_cfg, 8,
            "extension step at the gates, raw features",
            step=lambda mo, op, b, cf, **kw: extension_train_step(
                mo, labeler, op, b, cf, None, **kw))
    if c["masked_knn2"] != 1:
        raise AssertionError("the gated step on raw features is not one K8 "
                             "launch")
    feats.clear()
    rows["masked_knn2_raw"] = check_calls(
        "K8 masked_knn2 on the labeler's raw features (the gated step's "
        "matching)", knn_calls["masked_knn_batched"], knn.masked_knn_batched,
        knn.masked_knn_batched_plain, _knn2_cost,
        _gap_scaled(_knn2_close, feats))
    log(f"  the features' largest squared norm {max(feats):.4g}; gated "
        f"step loss {float(m['loss']):.6f}, {ms:.2f} ms, on {smi}")
    launches["masked_knn2_raw"] = c["masked_knn2"]
    return rows, launches


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def k6_backward_replayed(outputs: list):
    """K6's backward (take_rows_backward) adds with float atomics, so two
    runs of one train step differ in the last bits wherever a row is
    gathered twice (up to ~6e-5 in a grad on an H100). While the block
    runs: with `outputs` empty, each call's output is kept in it; else the
    calls return those outputs in order, every other kernel running, so
    that two steps that must agree can be held to the same bits."""
    from eyoc_tpu_torch.ops import rows
    real = rows.take_rows_backward
    replay = iter(list(outputs)) if outputs else None

    def keep(*a, **k):
        out = real(*a, **k)
        outputs.append(out.clone())
        return out

    rows.take_rows_backward = keep if replay is None else \
        (lambda *a, **k: next(replay).clone())
    try:
        yield
    finally:
        rows.take_rows_backward = real


def ddp_phase(train_batch, tcfg, smi):
    """Data parallelism over NCCL at world size 1: the plain step, the DP
    step and the DP step with the collectives forced at one rank (K7's
    sums all_reduce'd, K21's two-launch form), each from the same fresh
    ResUNetBN2C and draws, with the plain step's K6-backward outputs
    replayed into the other two (`k6_backward_replayed`): metrics and
    states bit-equal. K21's two-launch form checked on its recorded
    calls: the one-launch form's bits and the plain version's values.
    Returns ({row: row}, {row: launches})."""
    import torch
    import torch.distributed as dist
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.parallel import ddp
    from eyoc_tpu_torch.sparse import norm
    from eyoc_tpu_torch.training.optim import sgd
    spec = load_model("ResUNetBN2C")
    sync_group = norm.sync_group
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        def fresh():
            model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32,
                              5, device="cuda")
            return model, sgd(model.parameters(), lr=0.1, momentum=0.8,
                              weight_decay=1e-4)

        def dp_step(model, opt, batch, cfg, **kw):
            return ddp.dp_train_step("base", model, opt, batch, cfg, **kw)

        runs, k6 = {}, []
        for what, step in (("plain", None), ("dp", dp_step),
                           ("dp, collectives forced", dp_step)):
            # forced: a group of one rank reduces as a larger one does
            # (norm.sync_group keeps it), where the collectives change no
            # bit
            norm.sync_group = (lambda g: g) if what.endswith("forced") \
                else sync_group
            model, opt = fresh()
            sites = [(norm, "masked_norm_backward_sums"),
                     (norm, "masked_norm_backward_finish")]
            with recording(sites) as calls, k6_backward_replayed(k6):
                m, c, ms = _one_step(model, opt, train_batch, tcfg, 5,
                                     f"{what} step", step=step)
            runs[what] = (m, model.state_dict(), c, ms, calls)
        norm.sync_group = sync_group
        m0, s0, c0, _, _ = runs["plain"]
        for what in ("dp", "dp, collectives forced"):
            m, st, c, ms, calls = runs[what]
            if not all(torch.equal(m0[k], m[k]) for k in m0) or \
                    not all(torch.equal(v, st[k]) for k, v in s0.items()):
                raise AssertionError(f"the {what} step at world size 1 "
                                     "differs from the plain step")
            log(f"{what} step at world size 1 over NCCL: loss "
                f"{float(m['loss']):.6f}, every parameter and statistic the "
                f"plain step's bits ({len(k6)} K6-backward outputs "
                f"replayed), {ms:.2f} ms (host clock, the first)")
        _, _, c, _, calls = runs["dp, collectives forced"]
        n_bn = norm_counts(fresh()[0])[1]
        if c["masked_norm_backward_sync"] != 2 * n_bn or \
                c["masked_norm_backward_bn"] or \
                c["masked_channel_sums"] != 2 * n_bn:
            raise AssertionError(f"the forced DP step: {c} (K21's two-launch "
                                 f"form {2 * n_bn} times expected)")
        if runs["dp"][2]["masked_norm_backward_sync"]:
            raise AssertionError("the DP step at world size 1 ran K21's "
                                 "two-launch form")
        sync = []
        for (a, k), (fa, fk) in zip(calls["masked_norm_backward_sums"],
                                    calls["masked_norm_backward_finish"]):
            x, mask, S, stats, dy, y, dpre = a
            sync.append(((x, mask, S, fa[3], stats, dy, y, dpre, fa[-1]),
                         {}))

        def two_launch(x, mask, S, scale, stats, dy, y=None, dpre=None,
                       residual=False):
            own = norm.masked_norm_backward_sums(x, mask, S, stats, dy, y,
                                                 dpre)
            return norm.masked_norm_backward_finish(
                x, mask, S, scale, stats, own, own, dy, y, dpre, residual)
        with torch.no_grad():
            for a, k in sync:
                one = norm.masked_norm_backward(*a, counter="masked_norm_"
                                                "backward_bn")
                two = two_launch(*a)
                if not all(u is None and w is None or torch.equal(u, w)
                           for u, w in zip(one, two)):
                    raise AssertionError("K21's two-launch form differs from "
                                         "its one launch")
        log(f"K21's two-launch form: each of its {len(sync)} calls gives the "
            "one-launch form's bits")
        label = "K21 masked_norm_backward, sync-BN's two-launch form"
        row = check_calls(label, sync, two_launch, _k21_plain, _k21_cost,
                          _k21_close, reps=SMALL_REPS // 4,
                          classify=_k21_class)
        row["library_ms"] = None
        log(f"  {label}: library: none: F.batch_norm's backward counts the "
            "padding rows")
        # the DP step's time beside the plain step's, in turns after a
        # first step of each
        times = {"plain": [], "dp": []}
        models = {k: fresh() for k in times}
        for i in range(4):
            for what, step in (("plain", None), ("dp", dp_step)):
                model, opt = models[what]
                _, _, ms = _one_step(model, opt, train_batch, tcfg, 6 + i,
                                     f"{what} step", step=step)
                if i:
                    times[what].append(ms)
        model, opt = models["dp"]
        with recording(train_sites()) as calls:
            _one_step(model, opt, train_batch, tcfg, 10, "dp step",
                      step=dp_step)
        log(f"DP train step at world size 1 over NCCL, B={TRAIN_B}: "
            + ", ".join(f"{t:.2f}" for t in times["dp"]) + " ms; the plain "
            "step in turns " + ", ".join(f"{t:.2f}" for t in times["plain"])
            + f" ms (host clock, synchronized; their kernels' bounds "
            f"{calls_bound(calls):.4f} ms), on {smi}")
        return {"masked_norm_backward_sync": row}, \
            {"masked_norm_backward_sync": c["masked_norm_backward_sync"]}
    finally:
        norm.sync_group = sync_group
        dist.destroy_process_group()


def zoo_phase(pairs, train_batch, tcfg, cfg, smi):
    """Phase 12: ResUNetExpBN2C, extract_features with rgb and normals,
    normalize_feature=False and data parallelism at world size 1. Returns
    the kernels line's rows and their launches."""
    import torch
    t0 = time.perf_counter()
    rows, launches = {}, {}
    for fn in (lambda: expbn2c_phase(pairs, train_batch, tcfg, cfg, smi),
               lambda: extract_phase(pairs, smi),
               lambda: unnormalized_phase(pairs, train_batch, tcfg, smi),
               lambda: ddp_phase(train_batch, tcfg, smi)):
        r, n = fn()
        rows.update(r)
        launches.update(n)
        torch.cuda.empty_cache()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"phase 12 launched no {missing}")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return rows, launches


# ----------------------------------------------------------------- phase 13


# (a) the descriptor harness at the presets' published size: every cloud
# max_points keypoints (B = 1, N = 8000, S = 1600 seeds, every row valid);
# GT-consistent descriptors (one smooth function of the aligned position)
# with a share of corrupted rows, as tests/test_benchmarks.py:make_pairs
# builds them
DESC_N = 8000
DESC_NOISE = 0.3
DESC_KITTI_PAIRS = 4
DESC_SCENES = 2            # 3DMatch scenes of DESC_FRAGS fragments
DESC_FRAGS = 3
DESC_LOMATCH_PAIRS = 2
DESC_RTE, DESC_RRE = 0.1, 1.0        # phase 4's tolerances, m and deg
SC2_PATH = ("masked_argmin", "sc2_power_iteration", "sc2_nms",
            "sc2_seed_topk", "sc2_seed_transforms", "sc2_irls")
# (b) record_similarity over phase 10's tree
RECORD_PAIRS = 4
# (c) the 3DMatch configuration: FCGF's indoor voxel, the repo's defaults
# otherwise (ResUNetBN2C / 32, conv1 k = 5, HardestContrastiveLossTrainer,
# B = 4, rotation_range 360, voxel_capacity 32768, level shrink 2.0)
TDM_VOXEL = 0.025
TDM_B = 4
TDM_POINTS = 100_000       # raw points a fragment
TDM_FILL = 26_000          # level-0 voxels a fragment is cut to, about
TDM_FRAGS = 4              # fragments a scene: pairs (0,1) (1,2) (2,3) (0,2)
TDM_TRAIN_BITS = (9, 9, 9)  # +-6.4 m: a fragment under any rotation
TDM_TEST_BITS = (9, 9, 8)   # +-6.4 m in x, y, +-3.2 m in z: the rooms
TDM_TEST_PAIRS = 4


def _desc_pose(rng, max_t):
    """A random rotation of 0.2-1.0 rad about a random axis and a
    translation in [-max_t, max_t]^3 (make_pairs' draws)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.2, 1.0)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    T[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return T


def _desc_features(rng, world, width, scale, fpfh):
    """(f0, f1): a smooth function of the world position, f0 with
    DESC_NOISE of its rows replaced by noise; FCGF-like rows unit-norm,
    FPFH-like rows non-negative histograms left for the loader to
    normalise."""
    W = rng.normal(size=(3, width)).astype(np.float32)
    f1 = np.tanh(world @ W * scale).astype(np.float32)
    if fpfh:
        f1 = np.abs(f1) * 50.0
    f0 = f1.copy()
    bad = rng.random(len(world)) < DESC_NOISE
    f0[bad] = np.abs(rng.normal(size=(int(bad.sum()), width))) * (
        50.0 if fpfh else 1.0)
    if not fpfh:
        f0 /= np.linalg.norm(f0, axis=1, keepdims=True) + 1e-6
        f1 /= np.linalg.norm(f1, axis=1, keepdims=True) + 1e-6
    return f0.astype(np.float32), f1.astype(np.float32)


def desc_kitti_tree(root, n_pairs=DESC_KITTI_PAIRS, n=DESC_N, seed=30):
    """KITTI-preset npz pairs (xyz0, xyz1, features0, features1, gt_trans)
    of FCGF-32 descriptors, clouds uniform in a 40 m cube."""
    import os
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    gts = []
    for i in range(n_pairs):
        xyz0 = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        T = _desc_pose(rng, 5.0).astype(np.float32)
        xyz1 = (xyz0 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        f0, f1 = _desc_features(rng, xyz0, 32, 0.05, fpfh=False)
        np.savez(os.path.join(root, f"pair_{i}.npz"), xyz0=xyz0, xyz1=xyz1,
                 features0=f0, features1=f1, gt_trans=T)
        gts.append(T)
    return gts


def _write_info(path, pairs):
    with open(path, "w") as f:
        for i, j, n in pairs:
            f.write(f"{i}\t{j}\t{n}\n")
            for r in range(6):
                f.write(" ".join("300.0" if c == r else "0.0"
                                 for c in range(6)) + "\n")


def desc_3dmatch_tree(root, scenes, descriptor, width, seed):
    """The 3DMatch fragment tree: each scene DESC_FRAGS fragments of one
    world of DESC_N points in a 3 m cube seen from random poses
    (fragments/<scene>/cloud_bin_<i>_<descriptor>.npz, fields xyz and
    feature), gt_result/<scene>-evaluation/gt.log (target->source, as
    3DMatch stores it) and gt.info, and bench/<scene>/ with gt.log of the
    src->tgt poses (the convention benchmark_trajectories compares the
    harness's poses in) and gt.info. Returns the src->tgt poses in the
    scenes' order."""
    import os
    from eyoc_tpu_torch.benchmarks.gtlog import write_gt_log
    rng = np.random.default_rng(seed)
    gts = []
    for scene in scenes:
        frag = os.path.join(root, "fragments", scene)
        gt_dir = os.path.join(root, "gt_result", f"{scene}-evaluation")
        bench = os.path.join(root, "bench", scene)
        for d in (frag, gt_dir, bench):
            os.makedirs(d)
        world = rng.uniform(0, 3, (DESC_N, 3)).astype(np.float32)
        poses = [_desc_pose(rng, 1.0) for _ in range(DESC_FRAGS)]
        f_bad, f_good = _desc_features(rng, world, width, 0.3,
                                       fpfh=descriptor == "fpfh")
        for fid, P in enumerate(poses):
            xyz = (world @ P[:3, :3].T + P[:3, 3]).astype(np.float32)
            np.savez(os.path.join(frag, f"cloud_bin_{fid}_{descriptor}.npz"),
                     xyz=xyz, feature=f_bad if fid == 0 else f_good)
        pairs = [(i, j, DESC_FRAGS) for i in range(DESC_FRAGS)
                 for j in range(i + 1, DESC_FRAGS)]
        src_tgt = [poses[j] @ np.linalg.inv(poses[i]) for i, j, _ in pairs]
        write_gt_log(os.path.join(gt_dir, "gt.log"), pairs,
                     [np.linalg.inv(T) for T in src_tgt])
        write_gt_log(os.path.join(bench, "gt.log"), pairs, src_tgt)
        _write_info(os.path.join(gt_dir, "gt.info"), pairs)
        _write_info(os.path.join(bench, "gt.info"), pairs)
        gts += [T.astype(np.float32) for T in src_tgt]
    return gts


def desc_lomatch_index(root, scene, n_pairs=DESC_LOMATCH_PAIRS):
    """A 3DLoMatch.pkl over `scene` of the fcgf tree: its first pairs,
    rot / trans the src->tgt pose (read back from the tree's gt.log and
    inverted, as the scene loader does)."""
    import os
    import pickle
    from eyoc_tpu_torch.benchmarks.gtlog import read_gt_log
    pairs, traj = read_gt_log(os.path.join(root, "gt_result",
                                           f"{scene}-evaluation", "gt.log"))
    infos = {"rot": [], "trans": [], "src": [], "tgt": []}
    gts = []
    for k in range(n_pairs):
        G = np.linalg.inv(traj[k])
        infos["rot"].append(G[:3, :3])
        infos["trans"].append(G[:3, 3])
        infos["src"].append(f"3DLoMatch/{scene}/cloud_bin_{pairs[k, 0]}.pth")
        infos["tgt"].append(f"3DLoMatch/{scene}/cloud_bin_{pairs[k, 1]}.pth")
        gts.append(G.astype(np.float32))
    path = os.path.join(root, "3DLoMatch.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path, gts


def harness_run(what, argv, gts, use_icp, expect):
    """descriptor_eval.main(argv) on the card, each pair's registration
    recorded: launch counts reset just before and read just after (each of
    `expect` launched), each pose the bits of sc2_pcr_estimator (and ICP
    at 0.10 m, 30 rounds) called on the same padded tensors, within
    DESC_RTE / DESC_RRE of its known pose, and RR 100. Returns (the
    result, the counts, the recorded calls)."""
    import torch
    from eyoc_tpu_torch.benchmarks import descriptor_eval as de
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.registration.icp import icp_point_to_point
    from eyoc_tpu_torch.registration.sc2pcr import sc2_pcr_estimator
    from eyoc_tpu_torch.utils import kernels

    records = []
    real = de.register_padded

    def rec(*a, **k):
        out = real(*a, **k)
        records.append((a, k, out))
        return out
    de.register_padded = rec
    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        res = de.main(argv)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
    finally:
        de.register_padded = real
    missing = [k for k in expect if counts[k] <= 0]
    if missing or len(records) != len(gts) or res["n"] != len(gts):
        raise AssertionError(f"harness ({what}): {len(records)} pairs, "
                             f"launched no {missing}")
    worst_te = worst_re = 0.0
    for (a, _, (trans, _, _)), gt in zip(records, gts):
        x0, f0, m0, x1, f1, m1, cfg = a
        if not (x0.shape[0] == DESC_N and bool(m0.all()) and bool(m1.all())
                and cfg.num_seeds == 1600):
            raise AssertionError(f"harness ({what}): not N = {DESC_N}, "
                                 "S = 1600 with every row valid")
        want = sc2_pcr_estimator(x0, f0, m0, x1, f1, m1, cfg)[0]
        if use_icp:
            want = icp_point_to_point(x0, m0, x1, m1, want,
                                      max_corr_dist=0.10, iterations=30)[0]
        if not torch.equal(want, trans):
            raise AssertionError(
                f"harness ({what}): a pose differs from sc2_pcr_estimator's"
                + (" + ICP's" if use_icp else "") + " on the same tensors "
                f"by {float((want - trans).abs().max())}")
        _, te, re = registration_success(
            trans, torch.from_numpy(np.asarray(gt, np.float32)).cuda())
        worst_te, worst_re = max(worst_te, float(te)), max(worst_re,
                                                           float(re))
    if worst_te >= DESC_RTE or worst_re >= DESC_RRE or res["rr"] != 100.0:
        raise AssertionError(f"harness ({what}): RR {res['rr']}, worst RTE "
                             f"{worst_te} m, RRE {worst_re} deg")
    # the scene protocol's result holds each scene's
    parts = res.get("scenes", [res])
    n = sum(r["n"] for r in parts)
    precision = sum(r["precision"] * r["n"] for r in parts) / n
    model_ms = sum(r["model_time"] * r["n"] for r in parts) / n * 1e3
    log(f"harness, {what}: {res['n']} pairs, RR {res['rr']:.1f}, RE "
        f"{res['re_deg']:.4f} deg, TE {res['te_cm']:.4f} cm, inlier "
        f"precision {precision:.4f}, model_time "
        f"{model_ms:.3f} ms/pair (host clock: the pair's "
        f"padding on the host until its results are back, after a "
        f"synchronize); each pose the bits of the direct calls, worst RTE "
        f"{worst_te:.2e} m, RRE {worst_re:.2e} deg; launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    return res, counts, records


def harness_rows(records, suffix="_desc"):
    """The kernels line's rows of the harness's path at its shape, on the
    recorded calls of one KITTI pair (B = 1, N = 8000, S = 1600, every row
    valid): K2's feature 1-NN ([8000, 32] x [8000, 32]), K3, K4, K13-K15,
    and ICP's first round (K2 at D = 3, icp_solve); each against its plain
    version, with its device time and bound."""
    import torch
    from eyoc_tpu_torch.ops import knn
    from eyoc_tpu_torch.registration import icp, sc2pcr
    x0, f0, m0, x1, f1, m1, cfg = records[0][0]
    sc2_sites = [(sc2pcr, n) for n in SC2_PATH]
    with recording(sc2_sites) as calls:
        trans = sc2pcr.sc2_pcr_estimator(x0, f0, m0, x1, f1, m1, cfg)[0]
    with recording([(icp, "masked_argmin"), (icp, "icp_solve")]) as icalls:
        icp.icp_point_to_point(x0, m0, x1, m1, trans, max_corr_dist=0.10,
                               iterations=1)
    torch.cuda.synchronize()
    out = {}
    shape = f"B = 1, N = {DESC_N}, S = {cfg.num_seeds}, every row valid"
    for name, fn, plain, cost, close, cl in (
            ("masked_argmin", knn.masked_argmin, knn.masked_argmin_plain,
             _argmin_cost, _argmin_close, calls["masked_argmin"]),
            ("sc2_power_iteration", sc2pcr.sc2_power_iteration,
             sc2pcr.sc2_power_iteration_plain, _power_cost, _power_close,
             calls["sc2_power_iteration"]),
            ("sc2_seed_topk", sc2pcr.sc2_seed_topk,
             sc2pcr.sc2_seed_topk_plain, _topk_cost, _exact,
             calls["sc2_seed_topk"]),
            ("icp_solve", icp.icp_solve, icp.icp_solve_plain,
             _icp_solve_cost, _icp_solve_close, icalls["icp_solve"][:1]),
            ("masked_argmin_icp", knn.masked_argmin,
             knn.masked_argmin_plain, _argmin_cost, _k2_icp_close,
             icalls["masked_argmin"][:1])):
        if len(cl) != 1:
            raise AssertionError(f"harness rows: {len(cl)} calls of {name}")
        out[name + suffix] = check_calls(
            f"{name}, the descriptor harness ({shape})", cl, fn, plain,
            cost, close)
        same_bits_twice(f"{name} (descriptor harness)", fn, cl)
    out.update(check_sc2_kernels(
        f"the descriptor harness, S = {cfg.num_seeds}, every row valid",
        {k: calls[k] for k in SC2_KERNELS}, suffix))
    return out


def harness_phase(work, smi):
    """Phase 13 (a): `descriptor_eval.main` at the presets' size on the
    card: the KITTI preset on DESC_KITTI_PAIRS FCGF-32 pairs without and
    with --use_icp; the 3DMatch preset's scene protocol on DESC_SCENES
    scenes of FPFH-33 fragments (K2 on 64-wide zero-padded columns) with
    --gt_benchmark_folder (recall 1); the 3DLoMatch preset over a pickle
    index of DESC_LOMATCH_PAIRS pairs of an FCGF-32 tree; a pair of
    DESC_N + 1 keypoints raising ValueError before any launch. Returns
    (the kernels line's `_desc` rows, their launches)."""
    import os
    import torch
    from eyoc_tpu_torch.benchmarks import descriptor_eval as de
    from eyoc_tpu_torch.utils import kernels

    root = os.path.join(work, "descriptors")
    t0 = time.perf_counter()
    kitti_gts = desc_kitti_tree(os.path.join(root, "kitti"))
    names = de.THREEDMATCH_SCENES[:DESC_SCENES]
    fpfh_gts = desc_3dmatch_tree(os.path.join(root, "fpfh"), names, "fpfh",
                                 33, seed=31)
    desc_3dmatch_tree(os.path.join(root, "fcgf"), names[:1], "fcgf", 32,
                      seed=32)
    pkl, lo_gts = desc_lomatch_index(os.path.join(root, "fcgf"), names[0])
    log(f"harness trees: {time.perf_counter() - t0:.1f} s on the host")

    kitti = ["--root", os.path.join(root, "kitti"), "--dataset", "KITTI",
             "--descriptor", "fcgf"]
    res, sc2_counts, records = harness_run(
        "KITTI preset, FCGF-32", kitti, kitti_gts, False, SC2_PATH)
    _, icp_counts, _ = harness_run(
        "KITTI preset, FCGF-32, --use_icp", kitti + ["--use_icp"],
        kitti_gts, True, SC2_PATH + ("icp_solve",))
    scenes = de.THREEDMATCH_SCENES
    de.THREEDMATCH_SCENES = names
    try:
        res3, _, _ = harness_run(
            "3DMatch preset, FPFH-33, scene protocol",
            ["--root", os.path.join(root, "fpfh"), "--dataset", "3DMatch",
             "--descriptor", "fpfh", "--scene_protocol",
             "--gt_benchmark_folder", os.path.join(root, "fpfh", "bench")],
            fpfh_gts, False, SC2_PATH)
    finally:
        de.THREEDMATCH_SCENES = scenes
    traj = res3["trajectory"]
    if traj["mean_recall"] != 1.0 or traj["mean_precision"] != 1.0:
        raise AssertionError(f"the trajectory benchmark: {traj}")
    log(f"harness, the Redwood trajectory benchmark over a bench tree of "
        f"src->tgt poses, written to match the convention "
        f"benchmark_trajectories reads (not 3DMatch's own tgt->src gt.log, "
        f"so this does not validate the protocol against it): recall "
        f"{traj['mean_recall']}, precision {traj['mean_precision']}, RE "
        f"{traj['mean_re_deg']:.4f} deg, TE {traj['mean_te_m']:.5f} m")
    harness_run("3DLoMatch preset, FCGF-32, pickle index",
                ["--root", os.path.join(root, "fcgf"), "--dataset",
                 "3DLoMatch", "--descriptor", "fcgf", "--lomatch_pkl", pkl],
                lo_gts, False, SC2_PATH)

    over = os.path.join(root, "over")
    desc_kitti_tree(over, n_pairs=1, n=DESC_N + 1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    try:
        de.main(["--root", over])
        raise AssertionError(f"harness: a pair of {DESC_N + 1} keypoints "
                             "raised nothing")
    except ValueError as e:
        if f"max_points {DESC_N}" not in str(e):
            raise
        msg = str(e)
    if any(kernels.launches.values()):
        raise AssertionError("harness: the pair above the cap launched "
                             "kernels")
    log(f"harness: a pair of {DESC_N + 1} keypoints raises before any "
        f"launch: {msg}")

    rows = harness_rows(records)
    n_pairs = res["n"]
    launches = {f"{k}_desc": sc2_counts[k] for k in SC2_PATH}
    launches["icp_solve_desc"] = icp_counts["icp_solve"]
    launches["masked_argmin_icp_desc"] = (icp_counts["masked_argmin"]
                                          - n_pairs)
    return rows, launches


def record_phase(work, runbook, smi):
    """Phase 13 (b): `tools.record_similarity.main` on the card over phase
    10's tree and imported checkpoint (ResUNetBN2C / 32), the train-phase
    loader of KITTINMPairDataset with supervised GT pairs, RECORD_PAIRS
    pairs, at caps (16384, 5120, 1600, 500) (voxel_capacity CAPS[0],
    shrink 3.2: the tool takes the config's caps) and phase 3's window
    bits: the voxel kernels, K1, K2 (D = 3) and K6 launched; each pair's
    triples under `valid` equal to the plain gathers' on the same features
    (d0 / d1 bit-equal, cos within 1e-6); the written tables read back by
    `load_similarity_tables`; the tables driving `spatial_filter_mask` on
    the card as a lookup of the same cells on the host."""
    import os
    import torch
    from eyoc_tpu_torch.data import datasets
    from eyoc_tpu_torch.ops import matching
    from eyoc_tpu_torch.tools import record_similarity as rs
    from eyoc_tpu_torch.utils import kernels

    out = os.path.join(work, "rec_distSimPlot.npz")
    split_file = datasets._split_file
    datasets._split_file = lambda name: runbook["split"]
    try:
        with recording([(rs, "dist_similarity_samples")]) as calls:
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            tables, secs = rs.main(
                ["--checkpoint", runbook["checkpoint"], "--dataset",
                 "KITTINMPairDataset", "--kitti_root", runbook["kitti_root"],
                 "--out", out, "--max_pairs", str(RECORD_PAIRS)],
                config_overrides=dict(
                    voxel_capacity=CAPS[0], level_capacity_shrink=3.2,
                    window_bits=",".join(map(str, WINDOW_BITS))))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.launches)
    finally:
        datasets._split_file = split_file
    expect = COORD_KERNELS + ("sparse_conv", "masked_argmin", "take_rows")
    missing = [k for k in expect if counts[k] <= 0]
    if missing or len(calls["dist_similarity_samples"]) != RECORD_PAIRS:
        raise AssertionError(f"record_similarity: "
                             f"{len(calls['dist_similarity_samples'])} pairs,"
                             f" launched no {missing}")
    if counts["take_rows"] != 4 * RECORD_PAIRS:
        raise AssertionError(f"record_similarity: {counts['take_rows']} K6 "
                             "launches, not four a pair")
    worst, n_valid = 0.0, 0
    for a, k in calls["dist_similarity_samples"]:
        got = rs.dist_similarity_samples(*a, **k)
        want = rs.dist_similarity_samples_plain(*a, **k)
        v = want[3]
        if not (torch.equal(got[3], v) and torch.equal(got[0][v], want[0][v])
                and torch.equal(got[1][v], want[1][v])):
            raise AssertionError("record_similarity: d0 / d1 / valid differ "
                                 "from the plain gathers'")
        err = float((got[2][v] - want[2][v]).abs().max()) if bool(
            v.any()) else 0.0
        if err > 1e-6:
            raise AssertionError(f"record_similarity: cos off by {err}")
        worst, n_valid = max(worst, err), n_valid + int(v.sum())
    if n_valid == 0:
        raise AssertionError("record_similarity: no valid correspondence")
    asset = matching._ASSET_DIR
    matching._ASSET_DIR = work
    try:
        st = matching.load_similarity_tables("rec")
    finally:
        matching._ASSET_DIR = asset
    for b, t in enumerate(tables):
        if not np.array_equal(st.maps[b, :t.shape[0], :t.shape[1]].numpy(),
                              t):
            raise AssertionError(f"record_similarity: table {b} reads back "
                                 "otherwise")
    # the filter on the card against a host lookup of the same cells, at
    # the median of the observed cells
    (x0, x1, *_, i0, i1, v), _ = calls["dist_similarity_samples"][0]
    e0, e1 = x0[i0.long()][v][None], x1[i1.long()][v][None]
    fd = torch.ones(1, dtype=torch.int32, device="cuda")
    seen = tables[0][tables[0] != 0]
    thresh = float(np.median(seen)) if seen.size else 0.0
    keep = matching.spatial_filter_mask(
        e0, e1, spatial_filter="Similarity", similarity=st.to("cuda"),
        similarity_thresh=thresh, frame_distance=fd)[0].cpu().numpy()
    r0 = e0[0].double().norm(dim=-1).cpu().numpy()
    r1 = e1[0].double().norm(dim=-1).cpu().numpy()
    tab = tables[0]
    col = np.minimum((np.minimum(r0, r1) / 5.0).astype(np.int64),
                     tab.shape[1] - 1)
    row = np.minimum((np.abs(r0 - r1) / 1.0).astype(np.int64),
                     tab.shape[0] - 1)
    host = tab[row, col] > thresh
    n_diff = int((host != keep).sum())
    # a range within an f32 rounding of a cell edge may fall either side
    edge = (np.abs(np.minimum(r0, r1) / 5.0 - np.round(np.minimum(r0, r1)
                                                       / 5.0)) < 1e-4) | (
        np.abs(np.abs(r0 - r1) - np.round(np.abs(r0 - r1))) < 1e-4)
    if int((host != keep)[~edge].sum()):
        raise AssertionError(f"record_similarity: the filter keeps "
                             f"{int(keep.sum())}, the host lookup "
                             f"{int(host.sum())} of {len(keep)}")
    log(f"record_similarity: {RECORD_PAIRS} pairs of ResUNetBN2C (phase "
        f"10's imported checkpoint) on KITTINMPairDataset, {n_valid} valid "
        f"triples, cos within {worst:.2e} of the plain gathers' (d0 / d1 "
        f"bit-equal); tables {[t.shape for t in tables]} read back by "
        f"load_similarity_tables; the filter at {thresh:.4f} keeps "
        f"{int(keep.sum())} of {len(keep)} matches as the host lookup "
        f"({n_diff} at a cell edge differ); record step "
        f"{np.mean(secs) * 1e3:.2f} ms/pair (host clock, the copy to the "
        f"card until the triples are on the host; pairs "
        + ", ".join(f"{s * 1e3:.2f}" for s in secs) + f"), main() "
        f"{wall:.1f} s with the loader; launches "
        + json.dumps({k: v for k, v in counts.items() if v}) + f"; on {smi}")


def _room(rng):
    """A room of 3.5-5 m x 3-4.5 m x 2.6 m centred on the origin in x, y
    with its floor at z = 0: the floor, 4 walls and 3 boxes, as
    rectangles (origin, u, v)."""
    W, D, H = rng.uniform(3.5, 5.0), rng.uniform(3.0, 4.5), 2.6
    o = np.array([-W / 2, -D / 2, 0.0])
    ex, ey, ez = np.array([W, 0, 0]), np.array([0, D, 0]), np.array([0, 0, H])
    rects = [(o, ex, ey), (o, ex, ez), (o, ey, ez), (o + ex, ey, ez),
             (o + ey, ex, ez)]
    for _ in range(3):
        s = rng.uniform(0.4, 1.0, 3)
        c = np.array([rng.uniform(-W / 2 + 0.6, W / 2 - 0.6),
                      rng.uniform(-D / 2 + 0.6, D / 2 - 0.6), 0.0])
        b = c - [s[0] / 2, s[1] / 2, 0]
        bx, by, bz = np.diag(s)
        rects += [(b + bz, bx, by), (b, bx, bz), (b + by, bx, bz),
                  (b, by, bz), (b + bx, by, bz)]
    return rects


def _surface_points(rng, rects, n):
    area = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects])
    k = rng.choice(len(rects), n, p=area / area.sum())
    O, U, V = (np.stack([r[i] for r in rects])[k] for i in range(3))
    return O + rng.random(n)[:, None] * U + rng.random(n)[:, None] * V


def _n_voxels(p, voxel):
    c = np.floor(p / voxel).astype(np.int64) + 1024
    return len(np.unique((c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]))


def room_fragment(rng, rects):
    """TDM_POINTS surface points (2 mm noise) of the room nearest a
    viewpoint, sampled at the density (points a m^2, searched between 2000
    and 20000) at which they fill about TDM_FILL voxels at TDM_VOXEL."""
    c = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                  rng.uniform(0.8, 1.6)])
    area = sum(np.linalg.norm(np.cross(u, v)) for _, u, v in rects)
    lo, hi = 2000.0, 20000.0
    for it in range(7):
        density = hi if it == 6 else np.sqrt(lo * hi)
        cand = _surface_points(rng, rects, int(density * area))
        near = np.argpartition(np.linalg.norm(cand - c, axis=1),
                               TDM_POINTS)[:TDM_POINTS]
        p = cand[near] + rng.normal(0, 0.002, (TDM_POINTS, 3))
        if _n_voxels(p, TDM_VOXEL) > TDM_FILL:
            lo = density
        else:
            hi = density
    return p.astype(np.float32)


def threedmatch_tree(root, splits):
    """A 3DMatch-format tree under `root`: for each scene of `splits`
    ({phase: [scene names]}) a room, TDM_FRAGS fragments <scene>_<i>.npz
    (field pcd, the room's frame shared by its fragments) and one overlap
    list <scene>@seq-01-0.30.txt of pairs (0,1) (1,2) (2,3) (0,2); a split
    file a phase. Returns ({phase: split file}, host seconds)."""
    import os
    t0 = time.perf_counter()
    os.makedirs(root)
    rng = np.random.default_rng(40)
    files = {}
    for phase, names in splits.items():
        for scene in names:
            rects = _room(rng)
            for i in range(TDM_FRAGS):
                np.savez(os.path.join(root, f"{scene}_{i}.npz"),
                         pcd=room_fragment(rng, rects))
            with open(os.path.join(root, f"{scene}@seq-01-0.30.txt"),
                      "w") as f:
                for i, j in ((0, 1), (1, 2), (2, 3), (0, 2)):
                    f.write(f"{scene}_{i}.npz {scene}_{j}.npz\n")
        files[phase] = os.path.join(root, f"split_{phase}.txt")
        with open(files[phase], "w") as f:
            f.write("\n".join(names) + "\n")
    return files, time.perf_counter() - t0


def level_fills(batch, caps, voxel, bits, what):
    """Each cloud's voxels at every level of the pyramid on the card
    against the host's count of its distinct cells at that level (the
    level-0 cells by the kernels' f32 division, inside the window), and
    the deepest level's bricks against its brick cap: a level that lost a
    voxel (a parent overflow drops voxels without a word) fails. Logs each
    level's fill of its cap."""
    import torch
    from eyoc_tpu_torch.sparse import morton
    from eyoc_tpu_torch.sparse.voxelize import quantize
    from eyoc_tpu_torch.training.pipeline import brick_caps, preprocess_clouds
    B = batch.xyz0.shape[0]
    bcaps = brick_caps(caps)
    L = len(caps)
    fills = np.zeros((2 * B, L + 1), np.int64)
    for side, (xyz, n) in enumerate(((batch.xyz0, batch.n0),
                                     (batch.xyz1, batch.n1))):
        _, pyr = preprocess_clouds(xyz, n, caps=caps, voxel_size=voxel,
                                   window_bits=bits)
        for b in range(B):
            c = quantize(xyz[b, :int(n[b])].cpu(), voxel)
            c = (c[morton.in_window(c, bits)] + torch.tensor(
                morton.shift(bits), dtype=torch.int32)).long()
            for lvl in range(L + 1):
                cl = c >> lvl
                want = len(torch.unique((cl[:, 0] << 40) | (cl[:, 1] << 20)
                                        | cl[:, 2]))
                if lvl < L:
                    got = int(pyr.vox_masks[lvl].reshape(B, caps[lvl])[b]
                              .sum())
                else:
                    lev = pyr.levels[L - 1]
                    got = int((lev.bmask & (lev.bseg == b)).sum())
                cap = caps[lvl] if lvl < L else bcaps[-1]
                if got != want or want > cap:
                    raise AssertionError(
                        f"{what}: cloud {side}.{b} level {lvl}: {got} on the "
                        f"card, {want} distinct cells, cap {cap}")
                fills[side * B + b, lvl] = got
    caps_all = list(caps) + [bcaps[-1]]
    log(f"{what}: level fills (voxels a cloud, the deepest level's bricks "
        f"last; the most of {2 * B} clouds / cap): "
        + ", ".join(f"L{lvl} {int(fills[:, lvl].max())}/{cap} "
                    f"({fills[:, lvl].max() / cap:.2f})"
                    for lvl, cap in enumerate(caps_all))
        + "; every level equal to the host's distinct cells: no overflow")


def threedmatch_phase(work, smi):
    """Phase 13 (c): the 3DMatch configuration through the normal entry
    points on the card. A synthetic 3DMatch-format tree (`threedmatch_tree`:
    room-sized fragments of TDM_POINTS points, the train split's first two
    scene names, the val split's first, the test split's first), then
    `cli.train.main` with --dataset ThreeDMatchPairDataset --voxel_size
    0.025 and the repo's defaults otherwise (ResUNetBN2C / 32, conv1 5,
    HardestContrastiveLossTrainer, B = 4, rotation_range 360), one epoch of
    two steps and a validation of 2 pairs; --skip_initialization true, as
    the defaults' pair_max_dist -1 would put the base trainer in the
    identity-label mode of the LiDAR recipes; window bits TDM_TRAIN_BITS.
    Each level's fill checked on a train batch and a test pair; every
    kernel of the train step and the valid step launched; the loss finite.
    Then `cli.test.main` over the test split (TDM_TEST_PAIRS pairs, SC2-PCR,
    --window_bits 9,9,8): no point dropped by the window, the eval kernels
    launched, each pose the bits of `eval.test_pair` on the same batch and
    draws. Last, one train step's device time (torch.profiler)."""
    import dataclasses
    import os
    import torch
    from eyoc_tpu_torch.cli import test as cli_test
    from eyoc_tpu_torch.cli.train import main as train_main
    from eyoc_tpu_torch.config import get_config
    from eyoc_tpu_torch.data import datasets
    from eyoc_tpu_torch.data.loader import make_data_loader
    from eyoc_tpu_torch.eval import test_pair
    from eyoc_tpu_torch.models import load_model
    from eyoc_tpu_torch.training.trainer import build_step_config
    from eyoc_tpu_torch.utils import kernels

    names = {}
    for phase, n in (("train", 2), ("val", 1), ("test", 1)):
        with open(datasets._split_file(f"{phase}_3dmatch.txt")) as f:
            names[phase] = f.read().split()[:n]
    root = os.path.join(work, "threedmatch")
    splits, secs = threedmatch_tree(root, names)
    log(f"3DMatch tree: scenes {names}, {TDM_FRAGS} fragments of "
        f"{TDM_POINTS} points each, {secs:.1f} s on the host")
    split_file = datasets._split_file

    def split_of(name):
        return splits[name.split("_")[0]]
    datasets._split_file = split_of
    out = os.path.join(work, "threedmatch_run")
    try:
        config = get_config([
            "--dataset", "ThreeDMatchPairDataset", "--threed_match_dir",
            root, "--voxel_size", str(TDM_VOXEL), "--model", "ResUNetBN2C",
            "--model_n_out", "32", "--conv1_kernel_size", "5",
            "--trainer", "HardestContrastiveLossTrainer", "--batch_size",
            str(TDM_B), "--rotation_range", "360", "--max_epoch", "1",
            "--skip_initialization", "true", "--window_bits",
            ",".join(map(str, TDM_TRAIN_BITS)), "--val_max_iter", "2",
            "--stat_freq", "1", "--out_dir", out])
        spec = load_model(config.model)
        tcfg, _ = build_step_config(config, spec)
        batch = next(iter(make_data_loader(config, "train", TDM_B)))
        level_fills(batch.to("cuda"), tcfg.caps, TDM_VOXEL, TDM_TRAIN_BITS,
                    f"3DMatch train batch (B = {TDM_B}, rotated)")
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        tr = train_main(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        expect = TRAIN_KERNELS + ("est_quad_linear_robust",)
        missing = [k for k in expect if counts[k] <= 0]
        if missing:
            raise AssertionError(f"3DMatch training launched no {missing}")
        if len(tr.epoch_log) != 1 or tr.epoch_log[0]["steps"] != 2:
            raise AssertionError(f"3DMatch training: {tr.epoch_log}")
        e = tr.epoch_log[0]
        if not all(np.isfinite(v) for v in e["metrics"].values()):
            raise AssertionError(f"3DMatch training: non-finite metrics "
                                 f"{e['metrics']}")
        if not os.path.exists(os.path.join(out, "best_val_checkpoint.pt")):
            raise AssertionError("3DMatch training wrote no "
                                 "best_val_checkpoint")
        m = ", ".join(f"{k} {v:.4f}" for k, v in e["metrics"].items())
        log(f"3DMatch training: {e['steps']} steps of B = {TDM_B}, Data "
            f"{e['data_s'] * 1e3:.1f} ms/step, Iter {e['iter_s'] * 1e3:.1f} "
            f"ms/step (the trainer's Timers; Iter includes Data), {m}; "
            f"validation {tr.best_val_metric} {tr.best_val:.4f}; main() "
            f"{wall:.1f} s; launches "
            + json.dumps({k: v for k, v in counts.items() if v})
            + f"; on {smi}")

        args = cli_test.parse_args([
            "--save_dir", out, "--use_RANSAC", "false", "--num_pairs",
            str(TDM_TEST_PAIRS), "--window_bits",
            ",".join(map(str, TDM_TEST_BITS))])
        tconfig = cli_test.load_test_config(args)
        _, ecfg = build_step_config(tconfig, spec)
        tb = next(iter(make_data_loader(tconfig, "test", 1)))
        level_fills(tb.to("cuda"), ecfg.caps, TDM_VOXEL, TDM_TEST_BITS,
                    "3DMatch test pair")
        record = []
        torch.cuda.synchronize()
        kernels.reset_counts()
        res = cli_test.main(tconfig, num_pairs=args.num_pairs, record=record)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        missing = [k for k in RUNBOOK_KERNELS["SC2-PCR"] if counts[k] <= 0]
        if missing or len(record) != TDM_TEST_PAIRS:
            raise AssertionError(f"3DMatch cli.test: {len(record)} pairs, "
                                 f"launched no {missing}")
        if res["dropped"] != 0:
            raise AssertionError(f"3DMatch cli.test: {res['dropped']} of the "
                                 "points fell outside the window")
        cfg = dataclasses.replace(ecfg, use_ransac=False)
        for b, state, T_est in record:
            gen = torch.Generator(device="cuda")
            gen.set_state(state)
            want = test_pair(tr.model, b, cfg, generator=gen)["T_est"]
            if not torch.equal(want, T_est):
                raise AssertionError(
                    "3DMatch cli.test: a pose differs from eval.test_pair's "
                    f"by {float((want - T_est).abs().max())}")
        log(f"3DMatch cli.test: {TDM_TEST_PAIRS} pairs with SC2-PCR, window "
            f"bits {TDM_TEST_BITS}, dropped {res['dropped']}, rr "
            f"{res['rr']:.4f}, rte {res['rte']:.4f} m, rre {res['rre']:.4f} "
            f"deg; Data {res['data_time'] * 1e3:.2f} ms, Feat "
            f"{res['feat_time'] * 1e3:.2f} ms, Reg {res['reg_time'] * 1e3:.2f}"
            f" ms a pair (host clock around synchronized calls); each pose "
            f"the bits of eval.test_pair; launches "
            + json.dumps({k: v for k, v in counts.items() if v})
            + f"; on {smi}")
        train_breakdown(tr.model, tr.opt, batch.to("cuda"), tcfg,
                        torch.Generator().manual_seed(13),
                        what=f"3DMatch train step (B = {TDM_B}, voxel "
                        f"{TDM_VOXEL} m)")
    finally:
        datasets._split_file = split_file


def tail_phase(work, runbook, smi):
    """Phase 13: the descriptor harness, record_similarity and the 3DMatch
    configuration (`harness_phase`, `record_phase`, `threedmatch_phase`).
    Returns the harness's kernels-line rows and their launches."""
    import torch
    t0 = time.perf_counter()
    rows, launches = harness_phase(work, smi)
    torch.cuda.empty_cache()
    record_phase(work, runbook, smi)
    torch.cuda.empty_cache()
    threedmatch_phase(work, smi)
    torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return rows, launches


def main() -> int:
    import dataclasses

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from eyoc_tpu_torch.eval import EvalConfig, embed_pair, register_pair
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.ops.matching import load_similarity_tables
    from eyoc_tpu_torch.registration.sc2pcr import (SC2PCRConfig, sc2_pcr,
                                                    sc2_pcr_batched)
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import TrainConfig
    from eyoc_tpu_torch.utils import kernels

    # ---- phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"build: {kernels.build_all():.1f} s for {len(kernels.KERNELS)} "
        "kernels")

    t0 = time.perf_counter()
    pairs = make_pairs()
    log(f"data: {N_PAIRS} synthetic pairs at d={PAIR_DIST} m, {RAW} raw "
        f"points, {time.perf_counter() - t0:.1f} s on the host")
    t0 = time.perf_counter()
    train_batch = make_train_batch().to("cuda")
    log(f"data: a batch of {TRAIN_B} synthetic train-phase pairs at "
        f"d={TRAIN_DIST} m, {RAW} raw points, "
        f"{time.perf_counter() - t0:.1f} s on the host")

    spec = load_model("ResUNetBN2C")
    gen = torch.Generator().manual_seed(0)
    model = init_unet(spec, gen, 1, 32, 5, device="cuda")
    cfg = EvalConfig(caps=CAPS, voxel_size=0.3, window_bits=WINDOW_BITS,
                     eval_sample_points=N_CORR,
                     sc2=SC2PCRConfig(max_points=N_CORR, seed_cap=N_SEEDS))

    # ---- phase 2: kernels against their plain versions
    b0 = pairs[0].to("cuda")
    # the coordinate kernels at the eval shape (the kernels line's rows),
    # then at the train shape with the inverses
    results = check_coord_kernels(b0.xyz0, b0.n0, False, "eval")
    check_coord_kernels(train_batch.xyz0, train_batch.n0, True, "train")
    torch.cuda.empty_cache()
    _, pyr = preprocess_clouds(b0.xyz0, b0.n0, caps=CAPS, voxel_size=0.3,
                               window_bits=WINDOW_BITS)
    results.update({
        "sparse_conv": check_sparse_conv(model, pyr),
        "masked_argmin": check_masked_argmin(gen),
        "sc2_power_iteration": check_power_iteration(gen),
    })
    # K3's bf16 form (on a generator of its own, so that the checks after
    # draw as before)
    results["sc2_power_iteration_bf16"] = check_power_iteration_bf16(
        torch.Generator().manual_seed(20))
    k4_sets = seed_sets(gen)
    results["sc2_seed_counts"] = check_seed_counts(k4_sets)
    results["sc2_seed_topk"] = check_seed_topk(k4_sets, cfg.sc2.k1)
    del k4_sets
    # K13-K15 at the eval shape (the kernels line's rows), then on the
    # labeling shape's synthetic problems (checked and logged)
    e_set = sc2_problems(gen, N_CORR, ((0.3, N_CORR - 50),))[:3]
    results.update(check_sc2_kernels("eval shape", sc2_calls(*e_set,
                                                             cfg.sc2)))
    sc2_no_sync("eval shape", *e_set, cfg.sc2)
    l_cfg = ext_config().sc2
    l_set = sc2_problems(gen, LABEL_N, LABEL_SPEC)[:3]
    check_sc2_kernels("labeling shape, synthetic",
                      sc2_calls(*l_set, l_cfg))
    sc2_no_sync("labeling shape, synthetic", *l_set, l_cfg)
    # past the shared-memory row cap of K15's cluster: its rows from the
    # global copy (on a generator of their own, so that the checks after
    # draw as before)
    from eyoc_tpu_torch.registration.sc2pcr import K15_CLUSTER, K15_MAX_ROWS
    cap = K15_CLUSTER * K15_MAX_ROWS
    n_over = cap + 808
    o_set = sc2_problems(torch.Generator().manual_seed(4), n_over,
                         ((0.3, n_over), (0.1, n_over - 500)))
    check_sc2_kernels(f"past K15's row cap {cap}", sc2_calls(
        *o_set[:3], SC2PCRConfig(max_points=n_over, seed_cap=N_SEEDS)))
    del e_set, l_set, o_set
    torch.cuda.empty_cache()
    # K23 and K24 (qcp_kabsch=False) at the eval shape and on the labeling
    # shape's synthetic problems, and K15 and K24 at refine_unroll = 4 (the
    # kernels line's rows; on generators of their own)
    jac = dataclasses.replace(cfg.sc2, qcp_kabsch=False)
    e_set = jacobi_eval_set()
    e_calls = sc2_calls(*e_set, jac)
    results.update(check_sc2_kernels(
        "eval shape, qcp_kabsch=False", e_calls, "_jacobi",
        which=SC2_KERNELS[1:]))
    check_k23_digests("eval", e_calls)
    sc2_no_sync("eval shape, qcp_kabsch=False", *e_set, jac)
    l_jac = dataclasses.replace(l_cfg, qcp_kabsch=False)
    l_set = jacobi_label_set()
    l_calls = sc2_calls(*l_set, l_jac)
    results.update(check_sc2_kernels(
        "labeling shape, synthetic, qcp_kabsch=False", l_calls,
        "_jacobi_label", which=SC2_KERNELS[1:]))
    check_k23_digests("label", l_calls)
    del e_calls, l_calls
    for c, tail in ((cfg.sc2, "_unroll"), (jac, "_jacobi_unroll")):
        c = dataclasses.replace(c, refine_unroll=UNROLL)
        rows = check_sc2_kernels(f"eval shape, refine_unroll {UNROLL}"
                                 + (", qcp_kabsch=False" if tail != "_unroll"
                                    else ""), sc2_calls(*e_set, c), tail,
                                 which=SC2_KERNELS[1:])
        results["sc2_irls" + tail] = rows["sc2_irls" + tail]
    del e_set, l_set
    torch.cuda.empty_cache()
    log_reruns("phase 2, the K23 / K24 rows")
    # the Jacobi solve's branch-free forms against the IEEE ones
    check_jacobi_forms()
    # K16-K18 and K2 at ICP's shape (the kernels line's rows), and the
    # digests of the Jacobi solve's users there
    results.update(check_ransac_kernels(gen, pairs[0]))
    check_jacobi_digests()
    log_reruns("phase 2, the K16-K18 rows and digests")
    # K19 at the valid step's shape, K20 on one ResUNetIN2C forward (on a
    # generator of their own, so that the checks after draw as before)
    results["est_quad_linear_robust"] = check_k19(
        torch.Generator().manual_seed(12))
    results["masked_instance_norm"] = check_k20(pyr)
    torch.cuda.empty_cache()
    # the training kernels, on the calls of one full-width train step
    train_model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                            device="cuda")
    opt = sgd(train_model.parameters(), lr=0.1, momentum=0.8,
              weight_decay=1e-4)
    tcfg = TrainConfig(caps=CAPS, voxel_size=0.3, num_pos=1024 * TRAIN_B,
                       num_hn_samples=256 * TRAIN_B, window_bits=WINDOW_BITS)
    train_gen = torch.Generator().manual_seed(2)
    calls, m = record_train_step(train_model, opt, train_batch, tcfg,
                                 train_gen)
    log(f"recorded train step: loss {float(m['loss']):.6f}, "
        + ", ".join(f"{len(v)} {k}" for k, v in calls.items()))
    gt = calls["masked_argmin_batched"]
    if len(gt) != 1 or gt[0][0][0].shape[0] != TRAIN_B:
        raise AssertionError("the GT pairs of a step are not one K2 call "
                             f"over the batch: {len(gt)} calls")
    results.update(check_train_kernels(calls))
    del calls
    # the labeling kernels, on the calls of a published-recipe and a gated
    # extension step
    tables = load_similarity_tables("waymo").to("cuda")
    calls = record_extension_steps(spec, train_batch, tables)
    results.update(check_label_kernels(calls))
    sc2 = {k: calls[k] for k in SC2_KERNELS}
    for k, cl in sc2.items():
        if len(cl) != 1 or _sc2_valid(k, cl[0][0]).shape != (TRAIN_B,
                                                              LABEL_N):
            raise AssertionError(f"{k}: {len(cl)} calls in one labeling, "
                                 "not one over its 8 problems")
    results.update(check_sc2_kernels(
        f"the {TRAIN_B} SC2-PCR problems of one labeling", sc2, "_label"))
    del calls, sc2
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at full width
    coord_path_checks("eval path, cloud 0 of pair 0", b0.xyz0, b0.n0,
                      inverse=False)
    noise_gen = torch.Generator().manual_seed(1)
    x = embed_pair(model, b0, cfg)               # warm-up, not timed
    register_pair(*x, cfg, generator=noise_gen)
    torch.cuda.synchronize()
    kernels.reset_counts()
    feat_ms, reg_ms, n_ok = [], [], 0
    for batch in pairs:
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0, f0, m0, x1, f1, m1 = embed_pair(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T_est = register_pair(x0, f0, m0, x1, f1, m1, cfg,
                              generator=noise_gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        feat_ms.append((t1 - t0) * 1e3)
        reg_ms.append((t2 - t1) * 1e3)
        if not bool(torch.isfinite(T_est).all()):
            raise AssertionError(f"non-finite T_est {T_est}")
        for f, m in ((f0, m0), (f1, m1)):
            norms = f[m].norm(dim=1)
            if norms.numel() == 0 or float((norms - 1).abs().max()) > 1e-3:
                raise AssertionError("features are not unit-norm")
            if bool((f[~m] != 0).any()):
                raise AssertionError("features at invalid voxels are not 0")
        ok, te, re = registration_success(T_est, batch.T_gt[0])
        n_ok += int(ok)
        log(f"pair: voxels {int(m0.sum())}/{int(m1.sum())}, feat "
            f"{feat_ms[-1]:.2f} ms, reg {reg_ms[-1]:.2f} ms, RTE "
            f"{float(te):.3f} m, RRE {float(re):.3f} deg")
    counts = dict(kernels.launches)
    log(json.dumps({"eval_launch_counts": counts}))
    missing = [k for k in EVAL_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"eval path launched no {missing}")
    if counts["sc2_seed_topk"] != N_PAIRS or counts["sc2_seed_counts"]:
        raise AssertionError("the eval path is not one sc2_seed_topk a pair "
                             "and no sc2_seed_counts")
    if any(counts[k] != 2 * N_PAIRS for k in COORD_KERNELS):
        raise AssertionError("the eval path is not one K10, K11 and K12 call "
                             "for each cloud")
    if any(counts[k] != N_PAIRS for k in SC2_KERNELS):
        raise AssertionError("the eval path is not one K13, K14 and K15 call "
                             "a pair")
    if counts["masked_instance_norm"] or counts["est_quad_linear_robust"]:
        raise AssertionError("the BN model's test protocol launched K20 or "
                             "K19")
    largest_sort(model, pairs[0].to("cuda"), cfg, noise_gen,
                 N_SEEDS * N_CORR, "eval pair", forbid=((1, N_CORR),))
    log(f"main path: ResUNetBN2C, {N_PAIRS} pairs, feat "
        f"{np.mean(feat_ms):.2f} ms/pair, reg {np.mean(reg_ms):.2f} ms/pair "
        f"(host clock around synchronized calls), RR of the untrained net "
        f"{n_ok}/{N_PAIRS}, on {smi}")
    # the eval path with RANSAC, the test CLI's default estimator
    ransac_counts = ransac_eval_phase(model, pairs, cfg, smi)
    log_reruns("phase 3, the eval path with RANSAC")
    # the valid step, and its known answer
    valid_counts = valid_phase(model, pairs, cfg, smi)

    # ---- phase 4: registration sanity
    sanity = ((0.3, N_CORR), (0.1, N_CORR), (0.3, N_CORR // 10))
    src, tgt, valid, T_true = sc2_problems(torch.Generator().manual_seed(3),
                                           N_CORR, sanity)
    T_est, fit = sc2_pcr_batched(src, tgt, valid, cfg.sc2)
    for b, (inlier, nv) in enumerate(sanity):
        T1, f1 = sc2_pcr(src[b], tgt[b], valid[b], cfg.sc2)
        if not (torch.equal(T1, T_est[b]) and torch.equal(f1, fit[b])):
            raise AssertionError(f"sc2_pcr_batched problem {b} differs from "
                                 "its own B = 1 call")
        _, te, re = registration_success(T_est[b], T_true[b])
        if not (float(te) < 0.1 and float(re) < 1.0):
            raise AssertionError(f"sc2_pcr_batched missed a known pose "
                                 f"({inlier} inliers, {nv} valid rows): RTE "
                                 f"{float(te)} m, RRE {float(re)} deg")
        log(f"sc2_pcr_batched sanity, {inlier} inliers, {nv} of {N_CORR} "
            f"rows valid: RTE {float(te):.4f} m, RRE {float(re):.4f} deg, "
            "the same bits as its B = 1 call")
    option_counts = sc2_option_runs(sanity, src, tgt, valid, T_true,
                                    cfg.sc2, l_cfg)
    ransac_known_answers(sanity, src, tgt, valid, T_true)
    icp_counts = icp_known_answer(pairs[0])
    log_reruns("phase 4, SC2-PCR's options, RANSAC and ICP known answers")

    # ---- phase 5: the training path at full width
    train_counts = train_phase(train_model, opt, train_batch, tcfg,
                               train_gen, smi)
    del train_model, opt
    torch.cuda.empty_cache()

    # ---- phase 6: the EYOC extension step at full width
    ext_counts = extension_phase(spec, train_batch, tables, smi)
    gated_counts = gated_step(spec, train_batch, tables)
    known_answer(train_batch)
    del tables
    torch.cuda.empty_cache()

    # ---- phase 7: the instance-norm family's eval forward at full width
    in_counts = in_phase(pairs, cfg, smi)
    torch.cuda.empty_cache()

    # ---- phase 8: training the instance-norm family at full width
    tables = load_similarity_tables("waymo").to("cuda")
    in_rows, in_train_counts = in_train_phase(train_batch, tables, smi)
    results.update(in_rows)
    del tables
    torch.cuda.empty_cache()

    # ---- phase 9: the trainer through the train CLI, the optimizers and
    # the other losses
    trainer_phase(smi)
    torch.cuda.empty_cache()
    loss_rows, loss_launches = optimizer_and_loss_steps(train_batch, tcfg)
    results.update(loss_rows)
    torch.cuda.empty_cache()

    # ---- phase 10: the real-data runbook on a synthetic KITTI-format tree
    # (its directory stays for phase 13 and goes when the script exits)
    work = tempfile.mkdtemp(prefix="eyoc_runbook_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    runbook = runbook_phase(smi, work)[1]

    # ---- phase 11: feature widths other than 3 and 32
    width_phase()
    torch.cuda.empty_cache()

    # ---- phase 12: ResUNetExpBN2C, extract_features with rgb and normals,
    # normalize_feature=False, data parallelism
    zoo_rows, zoo_launches = zoo_phase(pairs, train_batch, tcfg, cfg, smi)
    results.update(zoo_rows)
    del pairs, train_batch
    torch.cuda.empty_cache()

    # ---- phase 13: the descriptor harness, record_similarity over phase
    # 10's tree, and the 3DMatch configuration through train and test
    tail_rows, tail_launches = tail_phase(work, runbook, smi)
    results.update(tail_rows)

    # one row per kernel and path: the eval rows take the eval run's
    # launches (phase 3), the training rows (K1 and K2 with the suffix
    # `_train`, and the training kernels) the training run's (phase 5),
    # the labeling rows (K2, K3 and K4 with the suffix `_label`) the
    # extension run's (phase 6), K8 and K9 the gated step's, K16-K18's
    # polish the RANSAC eval run's (phase 3), `icp_solve` and K2's `_icp`
    # row ICP's known answer (phase 4), K19 the valid run's (phase 3), K20
    # the instance-norm run's (phase 7), K20's `_train` row and K21's
    # instance-norm row the IN training run's (phase 8; K22 and K21's
    # batch-norm row are phase 5's), K2's `_triplet` row and K6's `_losses`
    # rows phase 9's loss steps; each row's times are of the calls of that
    # path
    def launches(name):
        if name in tail_launches:
            return tail_launches[name]
        if name in zoo_launches:
            return zoo_launches[name]
        if name in loss_launches:
            return loss_launches[name]
        if name in OPTION_ROWS:
            tag, counter = OPTION_ROWS[name]
            return option_counts[tag][counter]
        if name == "est_quad_linear_robust":
            return valid_counts[name]
        if name == "masked_instance_norm":
            return in_counts[name]
        if name in ("masked_instance_norm_train", "masked_norm_backward"):
            return in_train_counts[name.removesuffix("_train")]
        if name == "ransac_hypotheses":
            return ransac_counts["ransac_hypotheses_topk"]
        if name in RANSAC_KERNELS:
            return ransac_counts[name]
        if name in ("icp_solve", "masked_argmin_icp"):
            return icp_counts[name.removesuffix("_icp")]
        if name in EVAL_KERNELS or name == "sc2_seed_counts":
            return counts[name]
        if name.endswith("_label"):
            return ext_counts[name.removesuffix("_label")]
        if name in ("masked_knn2", "masked_argmin_excl"):
            return gated_counts[name]
        return train_counts[name.removesuffix("_train")]

    source = {"sparse_conv_dgrad": "sparse_conv",
              "sparse_conv_train": "sparse_conv",
              "masked_argmin_train": "masked_argmin",
              "masked_argmin_label": "masked_argmin",
              "take_rows_backward": "take_rows",
              "sc2_seed_topk": "sc2_seed_counts",
              "sc2_seed_topk_label": "sc2_seed_counts",
              "sc2_power_iteration_label": "sc2_power_iteration",
              "masked_argmin_excl": "masked_knn2",
              "sc2_nms_label": "sc2_nms",
              "sc2_seed_transforms": "sc2_refine",
              "sc2_seed_transforms_label": "sc2_refine",
              "sc2_irls": "sc2_refine", "sc2_irls_label": "sc2_refine",
              "ransac_hypotheses": "ransac", "ransac_verify": "ransac",
              "ransac_polish": "ransac", "icp_solve": "ransac",
              "masked_argmin_icp": "masked_argmin",
              "est_quad_linear_robust": "robust_irls",
              "masked_instance_norm": "instance_norm",
              "masked_instance_norm_train": "instance_norm",
              "masked_norm_apply": "instance_norm",
              "masked_norm_backward": "norm_backward",
              "masked_norm_backward_bn": "norm_backward",
              "masked_argmin_triplet": "masked_argmin",
              "take_rows_losses": "take_rows",
              "take_rows_backward_losses": "take_rows",
              "sc2_power_iteration_bf16": "sc2_power_iteration",
              "masked_norm_apply_eval": "instance_norm",
              "sparse_conv_ci3": "sparse_conv",
              "sparse_conv_ci6": "sparse_conv",
              "masked_argmin_raw": "masked_argmin",
              "masked_knn2_raw": "masked_knn2",
              "masked_norm_backward_sync": "norm_backward",
              "masked_argmin_desc": "masked_argmin",
              "sc2_power_iteration_desc": "sc2_power_iteration",
              "sc2_seed_topk_desc": "sc2_seed_counts",
              "sc2_nms_desc": "sc2_nms",
              "sc2_seed_transforms_desc": "sc2_refine",
              "sc2_irls_desc": "sc2_refine", "icp_solve_desc": "ransac",
              "masked_argmin_icp_desc": "masked_argmin"}
    source.update({k: "sc2_refine" for k in OPTION_ROWS
                   if k.startswith(("sc2_seed", "sc2_irls"))})
    replaces = {
        "sparse_conv": "eyoc_tpu/sparse/brick_conv.py:310",
        "sparse_conv_train": "eyoc_tpu/sparse/brick_conv.py:310",
        "sparse_conv_dgrad": "eyoc_tpu/sparse/brick_conv.py:259",
        "masked_argmin": "eyoc_tpu/ops/knn.py:79",
        "masked_argmin_train": "eyoc_tpu/ops/knn.py:79",
        "masked_argmin_label": "eyoc_tpu/ops/knn.py:31",
        "masked_knn2": "eyoc_tpu/ops/knn.py:58",
        "masked_argmin_excl": "eyoc_tpu/training/loss.py:97",
        "sc2_power_iteration_label": "eyoc_tpu/registration/sc2pcr.py:276",
        "sc2_seed_topk_label": "eyoc_tpu/registration/sc2pcr.py:296",
        "sc2_power_iteration": "eyoc_tpu/registration/sc2pcr.py:276",
        "sc2_seed_counts": "eyoc_tpu/registration/sc2pcr.py:296",
        "sc2_seed_topk": "eyoc_tpu/registration/sc2pcr.py:296",
        "sparse_conv_wgrad": "eyoc_tpu/sparse/brick_conv.py:259",
        "take_rows": "proto/proto_pallas_gather.py:62",
        "take_rows_backward": "eyoc_tpu/training/loss.py:94",
        "masked_channel_sums": "eyoc_tpu/sparse/norm.py:95",
        "voxelize": "eyoc_tpu/sparse/voxelize.py:24",
        "brick_pyramid": "eyoc_tpu/sparse/bricks.py:232",
        "conv_maps": "eyoc_tpu/sparse/brick_conv.py:95",
        "sc2_nms": "eyoc_tpu/registration/sc2pcr.py:151",
        "sc2_nms_label": "eyoc_tpu/registration/sc2pcr.py:151",
        "sc2_seed_transforms": "eyoc_tpu/registration/sc2pcr.py:161",
        "sc2_seed_transforms_label": "eyoc_tpu/registration/sc2pcr.py:161",
        "sc2_irls": "eyoc_tpu/registration/sc2pcr.py:219",
        "sc2_irls_label": "eyoc_tpu/registration/sc2pcr.py:219",
        "ransac_hypotheses": "eyoc_tpu/registration/ransac.py:55",
        "ransac_verify": "eyoc_tpu/registration/ransac.py:73",
        "ransac_polish": "eyoc_tpu/registration/ransac.py:148",
        "icp_solve": "eyoc_tpu/registration/icp.py:42",
        "masked_argmin_icp": "eyoc_tpu/registration/icp.py:41",
        "est_quad_linear_robust": "eyoc_tpu/geometry/robust.py:65",
        "masked_instance_norm": "eyoc_tpu/sparse/norm.py:119",
        "masked_instance_norm_train": "eyoc_tpu/sparse/norm.py:119",
        "masked_norm_apply": "eyoc_tpu/sparse/norm.py:113",
        "masked_norm_backward": "eyoc_tpu/sparse/norm.py:119",
        "masked_norm_backward_bn": "eyoc_tpu/sparse/norm.py:72",
        "masked_argmin_triplet": "eyoc_tpu/training/loss.py:259",
        "take_rows_losses": "proto/proto_pallas_gather.py:62",
        "take_rows_backward_losses": "eyoc_tpu/training/loss.py:201",
        "sc2_power_iteration_bf16": "eyoc_tpu/registration/sc2pcr.py:100",
        "sc2_seed_transforms_jacobi": "eyoc_tpu/registration/sc2pcr.py:161",
        "sc2_seed_transforms_jacobi_label":
            "eyoc_tpu/registration/sc2pcr.py:161",
        "sc2_irls_jacobi": "eyoc_tpu/registration/sc2pcr.py:219",
        "sc2_irls_jacobi_label": "eyoc_tpu/registration/sc2pcr.py:219",
        "sc2_irls_unroll": "eyoc_tpu/registration/sc2pcr.py:224",
        "sc2_irls_jacobi_unroll": "eyoc_tpu/registration/sc2pcr.py:224",
        "masked_norm_apply_eval": "eyoc_tpu/sparse/norm.py:113",
        "sparse_conv_ci3": "eyoc_tpu/sparse/brick_conv.py:310",
        "sparse_conv_ci6": "eyoc_tpu/sparse/brick_conv.py:310",
        "masked_argmin_raw": "eyoc_tpu/ops/knn.py:79",
        "masked_knn2_raw": "eyoc_tpu/ops/knn.py:58",
        "masked_norm_backward_sync": "eyoc_tpu/sparse/norm.py:98",
        "masked_argmin_desc": "eyoc_tpu/ops/knn.py:79",
        "sc2_power_iteration_desc": "eyoc_tpu/registration/sc2pcr.py:276",
        "sc2_seed_topk_desc": "eyoc_tpu/registration/sc2pcr.py:296",
        "sc2_nms_desc": "eyoc_tpu/registration/sc2pcr.py:151",
        "sc2_seed_transforms_desc": "eyoc_tpu/registration/sc2pcr.py:161",
        "sc2_irls_desc": "eyoc_tpu/registration/sc2pcr.py:219",
        "icp_solve_desc": "eyoc_tpu/registration/icp.py:42",
        "masked_argmin_icp_desc": "eyoc_tpu/registration/icp.py:41",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"eyoc_tpu_torch/csrc/{source.get(name, name)}.cu",
         "replaces": replaces[name],
         "launches": launches(name),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
         "device_ms": r["device_ms"], "bound_alt_ms": r.get("bound_alt_ms")}
        for name, r in results.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
