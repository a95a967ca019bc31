"""KITTI-like synthetic LiDAR pairs, numpy only (a copy of what
eyoc_tpu/data/datasets.py:SyntheticPairDataset and eyoc_tpu/data/augment.py
need to build one pair, so the port never imports the JAX package).

A structured scene (ground, street facades, roadside objects) is raycast
from two sensor poses `dist` apart by an HDL-64E-like scanner; with the
same seed the clouds are bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from eyoc_tpu_torch.training.pipeline import RawBatch


def rotation_about(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def sample_random_trans(pcd: np.ndarray, randg, rotation_range: float = 360.0) -> np.ndarray:
    T = np.eye(4)
    axis = randg.rand(3) - 0.5
    theta = rotation_range * np.pi / 180.0 * float(randg.rand(1)[0] - 0.5)
    R = rotation_about(axis, theta)
    T[:3, :3] = R
    T[:3, 3] = R.dot(-np.mean(pcd, axis=0))
    return T


def apply_transform(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return pts @ trans[:3, :3].T + trans[:3, 3]


def augment_pair(
    xyz0: np.ndarray,
    xyz1: np.ndarray,
    M2: np.ndarray,
    randg,
    *,
    random_rotation: bool = True,
    rotation_range: float = np.pi / 4,  # reference passes np.pi/4 (degrees!)
    random_scale: bool = False,
    min_scale: float = 0.8,
    max_scale: float = 1.2,
    search_voxel_size: float = 0.45,
):
    """Returns (xyz0, xyz1, trans, search_voxel_size) after augmentation.

    Mirrors KittiNFramePairDataset.__getitem__ (lib/data_loaders.py:905-933).
    """
    if random_rotation:
        T0 = sample_random_trans(xyz0, randg, rotation_range)
        T1 = sample_random_trans(xyz1, randg, rotation_range)
        trans = T1 @ M2 @ np.linalg.inv(T0)
        xyz0 = apply_transform(xyz0, T0)
        xyz1 = apply_transform(xyz1, T1)
    else:
        trans = M2.copy()

    if random_scale and randg.rand() < 0.95:
        scale = min_scale + (max_scale - min_scale) * randg.rand()
        search_voxel_size = search_voxel_size * scale
        xyz0 = scale * xyz0
        xyz1 = scale * xyz1
        trans = trans.copy()
        trans[:3, 3] = scale * trans[:3, 3]

    return (
        xyz0.astype(np.float32),
        xyz1.astype(np.float32),
        trans.astype(np.float32),
        float(search_voxel_size),
    )


class SyntheticPairs:
    """Synthetic raycast pairs; item `idx` builds scene `seed0 + idx`.

    phase "test" is the reference eval protocol: no rotation or scale
    augmentation (reference lib/data_loaders.py:1824-1831)."""

    GROUND_Z = -1.7
    seed0 = 1000
    POSE_FRACTION_FLOOR = 0.0

    def __init__(self, n_pairs: int = 64, n_points: int = 65536,
                 dist: float = 5.0, phase: str = "test",
                 voxel_size: float = 0.3, search_multiplier: float = 1.5,
                 facade_len_scale: float = 1.0,
                 facade_gap_scale: float = 1.0):
        self.n_pairs = n_pairs
        self.n_points = n_points
        self.dist = float(dist)
        self.phase = phase
        self.random_rotation = phase == "train"
        self.matching_search_voxel_size = voxel_size * search_multiplier
        self.facade_len_scale = facade_len_scale
        self.facade_gap_scale = facade_gap_scale
        self.randg = np.random.RandomState(0)

    def __len__(self):
        return self.n_pairs

    @staticmethod
    def make_scene(rng, d, extent=80.0, keepout=(), n_obj=110,
                   facade_len_scale=1.0, facade_gap_scale=1.0):
        """Primitive-soup world for one scene: yaw-rotated boxes (OBB),
        vertical cylinders and spheres composed into varied archetypes,
        plus articulated street facades along the road.

        Round-5 redesign rationale: the round-4 world (axis-aligned
        boxes + uniform walls) was statistically SELF-SIMILAR — every wall
        segment and box corner presented the same local occupancy pattern,
        so hardest-negative mining had nothing separable to learn and
        mutual-match hit saturated at ~2% (EXTENSION_DEMO.md §3/§6, the
        round-4 verdict's top item). Descriptors integrate occupancy over
        a ~10-20 m receptive field; what must vary non-repetitively is the
        supra-voxel (>=0.6 m) shape AND configuration of structure inside
        that window. Hence: 8 object archetypes at distinct scales with
        random yaw (corner angles vary), composite objects (trees =
        trunk+canopy, L-buildings, setback towers), and facades broken
        into segments of irregular height/depth with irregularly spaced
        pilasters/balconies and occasional corner towers — every
        neighborhood becomes a unique landmark configuration.

        Returns a dict of primitive arrays (world frame, z up, ground at
        GROUND_Z), each row carrying its world-texture amplitude `sigma`
        (see _world_texture; relief must exceed the 0.3 m voxel scale to
        reshape occupancy):
          obb: [M, 8]  cx, cy, cz, hx, hy, hz, yaw, sigma  (half-sizes)
          cyl: [K, 6]  cx, cy, z0, z1, r, sigma
          sph: [S, 5]  cx, cy, cz, r, sigma
        `keepout`: world xy sensor sites no primitive may cover (the road
        corridor |y| < 4.5 around the sensor line is also kept clear so
        structure cannot wall a sensor into a private pocket)."""
        G = SyntheticPairs.GROUND_Z
        obb, cyl, sph = [], [], []

        def add_box(cx, cy, z0, sx, sy, sz, yaw, sigma):
            obb.append((cx, cy, z0 + sz / 2, sx / 2, sy / 2, sz / 2,
                        yaw, sigma))

        # ---- scattered roadside objects: LiDAR-realistic radial density
        # around the pair midpoint (shifted by caller via `d`)
        rc = np.minimum(6.0 + rng.exponential(22.0, n_obj), extent)
        tc = rng.uniform(0, 2 * np.pi, n_obj)
        ox_all = rc * np.cos(tc) + d / 2
        oy_all = rc * np.sin(tc)
        kinds = rng.choice(8, n_obj,
                           p=[0.20, 0.12, 0.18, 0.16, 0.08, 0.07, 0.07, 0.12])
        for i in range(n_obj):
            x, y, k = ox_all[i], oy_all[i], kinds[i]
            # approximate footprint half-width per archetype, for the
            # road-corridor push-out and sensor keepout
            w = (2.5, 0.3, 3.0, 7.5, 9.0, 3.0, 4.5, 2.0)[k]
            need = max(0.0, 4.5 + w - abs(y))
            y = y + (need if y >= 0 else -need)
            if any((x - kx) ** 2 + (y - ky) ** 2 < (3.0 + w) ** 2
                   for kx, ky in keepout):
                x += 200.0          # relocate out of lidar range
            if k == 0:              # car
                add_box(x, y, G, rng.uniform(1.7, 2.2),
                        rng.uniform(3.6, 5.0), rng.uniform(1.3, 1.8),
                        rng.uniform(0, np.pi), 0.15)
            elif k == 1:            # pole / sign
                cyl.append((x, y, G, G + rng.uniform(3, 7),
                            rng.uniform(0.1, 0.3), 0.15))
            elif k == 2:            # tree: trunk + canopy
                ht = rng.uniform(2.0, 4.5)
                rcan = rng.uniform(1.2, 3.0)
                cyl.append((x, y, G, G + ht, rng.uniform(0.15, 0.4), 0.15))
                sph.append((x, y, G + ht + 0.6 * rcan, rcan, 0.5))
            elif k == 3:            # building (random yaw)
                add_box(x, y, G, rng.uniform(5, 14), rng.uniform(5, 14),
                        rng.uniform(4, 10), rng.uniform(0, np.pi / 2), 0.35)
            elif k == 4:            # L-building: main + wing at 90 deg
                yaw = rng.uniform(0, np.pi / 2)
                sx, sy = rng.uniform(6, 13), rng.uniform(5, 9)
                h = rng.uniform(4, 10)
                add_box(x, y, G, sx, sy, h, yaw, 0.35)
                # wing attached at one end, rotated frame offset
                off = (sx / 2) * np.array([np.cos(yaw), np.sin(yaw)])
                add_box(x + off[0], y + off[1], G, sy * 0.8, sx * 0.7,
                        h * rng.uniform(0.6, 1.1), yaw, 0.35)
            elif k == 5:            # silo / tank
                cyl.append((x, y, G, G + rng.uniform(3, 9),
                            rng.uniform(1.0, 3.0), 0.25))
            elif k == 6:            # setback tower: base + smaller top
                yaw = rng.uniform(0, np.pi / 2)
                sx, sy = rng.uniform(4.5, 8.5), rng.uniform(4.5, 8.5)
                hb = rng.uniform(3, 5)
                add_box(x, y, G, sx, sy, hb, yaw, 0.35)
                add_box(x + rng.uniform(-1, 1), y + rng.uniform(-1, 1),
                        G + hb, sx * 0.6, sy * 0.6, rng.uniform(2, 4.5),
                        yaw + rng.uniform(-0.4, 0.4), 0.35)
            else:                   # kiosk / shed
                add_box(x, y, G, rng.uniform(1.5, 3.5),
                        rng.uniform(1.5, 4.0), rng.uniform(2.0, 3.5),
                        rng.uniform(0, np.pi), 0.25)

        # ---- articulated street facades along the sensor line: walls
        # parallel to the road present the SAME face to both sensors —
        # the co-visible geometry that makes distant-pair registration
        # possible at all. Irregular per-segment height/depth + irregular
        # pilaster spacing break the translational self-similarity of a
        # long flat wall (the aperture problem that capped descriptor
        # learning in round 4).
        # two depth bands per side: a near row (storefront scale) and a
        # tall background row that stays visible over near clutter at
        # 30-45 m sensor separations (the skyline real streets provide) —
        # without it, occlusion from the richer clutter drops GT overlap
        # at d=30 to ~0.3 vs the round-4 world's 0.5
        for sgn in (-1.0, 1.0):
            for (ylo, yhi, hlo, hhi, llo, lhi, glo, ghi) in (
                    (7, 14, 2.5, 9.0, 7, 22, 1.5, 7.0),      # near row
                    (17, 30, 7.0, 18.0, 10, 30, 1.0, 5.0)):  # background
                # the scale factors multiply DRAWN values so the rng draw
                # sequence (and therefore every default-scale scene) is
                # bit-identical to scale 1.0; >1 len / <1 gap builds a more
                # continuous street wall = higher co-visible overlap at
                # 30+ m sensor separations (the §4 limit of the round-5
                # extension demo)
                x0 = rng.uniform(-30, -10)
                while x0 < d + 15:
                    L = rng.uniform(llo, lhi) * facade_len_scale
                    y = sgn * rng.uniform(ylo, yhi)
                    h = rng.uniform(hlo, hhi)
                    yaw = rng.normal(0, 0.04)
                    add_box(x0 + L / 2, y, G, L, 0.6, h, yaw, 0.35)
                    # pilasters / balconies protruding toward the road at
                    # irregular positions and heights
                    px = x0 + rng.uniform(0.5, 3.0)
                    while px < x0 + L - 0.5:
                        pd = rng.uniform(0.5, 1.0)
                        ph = rng.uniform(1.0, h)
                        z0 = G + (rng.uniform(0, max(0.0, h - ph))
                                  if rng.random() < 0.35 else 0.0)
                        add_box(px, y - sgn * (0.2 + pd / 2), z0,
                                rng.uniform(0.5, 1.4), pd, ph, yaw, 0.25)
                        px += rng.uniform(1.5, 5.0)
                    if rng.random() < 0.3:      # corner tower
                        rt = rng.uniform(0.8, 2.0)
                        cyl.append((x0 + L + rt, y, G,
                                    G + h + rng.uniform(1, 4), rt, 0.3))
                    x0 += L + rng.uniform(glo, ghi) * facade_gap_scale

        return {
            "obb": np.asarray(obb, np.float64).reshape(-1, 8),
            "cyl": np.asarray(cyl, np.float64).reshape(-1, 6),
            "sph": np.asarray(sph, np.float64).reshape(-1, 5),
        }

    @staticmethod
    def _terrain(rng_seed, xy):
        """Smooth deterministic height field (road crown / curbs / grass):
        a few low-frequency sinusoids, amplitude ~0.2 m. Seeded per pair so
        both scans displace the SAME world surface (consistent GT)."""
        r = np.random.default_rng(rng_seed)
        h = np.zeros(len(xy))
        for _ in range(6):
            k = r.uniform(0.02, 0.25, 2)
            ph = r.uniform(0, 2 * np.pi)
            h += r.uniform(0.04, 0.12) * np.sin(xy @ k + ph)
        return h

    @staticmethod
    def _world_texture(rng_seed, pts, n_terms=10):
        """World-anchored unit-RMS displacement field: sum of 3-D vector
        sinusoids of WORLD position, wavelengths log-uniform in 1.2-8 m
        (the 4-27 voxel scale local descriptors integrate over).

        Why it exists (round-4 probe result, proto_match_quality): analytic
        planes + per-scan random scatter give surface patches NO
        view-consistent local signature — identical everywhere (planes) or
        decorrelated between scans (random scatter) — so base training can
        only learn the sensor-relative ring geometry (feature-match hit
        0.3-1.6% at d=4, the identity-attractor failure of the extension
        demo). Real surfaces carry stable centimeter-scale relief (gravel,
        bark, brick, dents); this field is that relief, and because it is a
        function of world position it is bitwise-consistent across the two
        scans of a pair. Per-surface amplitude scales it (vegetation thick,
        walls medium, ground fine)."""
        r = np.random.default_rng(rng_seed)
        disp = np.zeros_like(pts)
        for _ in range(n_terms):
            wl = np.exp(r.uniform(np.log(1.2), np.log(8.0)))
            kdir = r.normal(size=3)
            kdir /= np.linalg.norm(kdir)
            u = r.normal(size=3)
            u /= np.linalg.norm(u)
            ph = r.uniform(0, 2 * np.pi)
            disp += u * np.sin(pts @ (2 * np.pi / wl * kdir) + ph)[:, None]
        # each component is a sum of n_terms sin() * u_i: normalize to ~unit RMS
        return disp / np.sqrt(n_terms / 2.0)

    @staticmethod
    def raycast_scan(rng, origin, yaw, scene, n_beams=64, n_az=2048,
                     max_range=80.0, terrain_seed=None):
        """HDL-64E-like scan: n_beams elevation rings x n_az azimuth rays,
        cast against ground plane (z=GROUND_Z) + the make_scene primitive
        soup (yaw-rotated boxes, vertical cylinders, spheres). Reproduces
        real LiDAR ring structure and range-dependent density, so voxel
        counts at 0.3 m match real KITTI scans (~15-25k voxels from ~130k
        points, SURVEY.md §5 'points-per-cloud scaling') instead of
        saturating the capacity budget the way uniform synthetic scenes do.

        Returns sensor-frame points [N, 3] float32 (z up, sensor at z=0).
        """
        G = SyntheticPairs.GROUND_Z
        el = np.deg2rad(np.linspace(-24.9, 2.0, n_beams))
        az = np.linspace(0, 2 * np.pi, n_az, endpoint=False) \
            + rng.uniform(0, 2 * np.pi / n_az)
        ce, se = np.cos(el), np.sin(el)
        ca, sa = np.cos(az + yaw), np.sin(az + yaw)
        # world-frame dirs [n_beams*n_az, 3]
        d = np.stack([np.outer(ce, ca), np.outer(ce, sa),
                      np.broadcast_to(se[:, None], (n_beams, n_az))],
                     -1).reshape(-1, 3).astype(np.float32)
        o = np.asarray(origin, np.float64)

        def near_xy(cx, cy, r):
            return (np.abs(cx - o[0]) < max_range + r) \
                & (np.abs(cy - o[1]) < max_range + r)

        # prune primitives that cannot be hit (keepout-relocated / far)
        obb = scene["obb"]
        obb = obb[near_xy(obb[:, 0], obb[:, 1],
                          np.hypot(obb[:, 3], obb[:, 4]))].astype(np.float32)
        cy_ = scene["cyl"]
        cy_ = cy_[near_xy(cy_[:, 0], cy_[:, 1], cy_[:, 4])].astype(np.float32)
        sp = scene["sph"]
        sp = sp[near_xy(sp[:, 0], sp[:, 1], sp[:, 3])].astype(np.float32)

        # OBB precompute: origin in each box frame (ct, st per box)
        bct, bst = np.cos(obb[:, 6]), np.sin(obb[:, 6])
        rx = (o[0] - obb[:, 0]).astype(np.float32)
        ry = (o[1] - obb[:, 1]).astype(np.float32)
        oxp = rx * bct + ry * bst
        oyp = -rx * bst + ry * bct
        ozp = (o[2] - obb[:, 2]).astype(np.float32)
        hx, hy, hz = obb[:, 3], obb[:, 4], obb[:, 5]
        # cylinder precompute
        qx = (o[0] - cy_[:, 0]).astype(np.float32)
        qy = (o[1] - cy_[:, 1]).astype(np.float32)
        cc = qx * qx + qy * qy - cy_[:, 4] ** 2
        # sphere precompute
        sq = (np.asarray(o, np.float32)[None, :] - sp[:, :3])
        sc = (sq * sq).sum(-1) - sp[:, 3] ** 2

        n_rays = len(d)
        tb = np.full(n_rays, np.inf, np.float32)      # best primitive t
        sig = np.full(n_rays, 0.15, np.float32)       # its texture sigma
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            tg = (G - o[2]) / d[:, 2]                 # ground plane
            tgnd = np.where((d[:, 2] < 0) & (tg > 0), tg,
                            np.inf).astype(np.float32)
            for a0 in range(0, n_rays, 4096):
                dc = d[a0:a0 + 4096]
                dx, dy, dz = dc[:, 0:1], dc[:, 1:2], dc[:, 2:3]
                tbest = np.full(len(dc), np.inf, np.float32)
                sbest = np.zeros(len(dc), np.float32)

                def consider(tcand, sigma_rows):
                    nonlocal tbest, sbest
                    k = np.argmin(tcand, -1)
                    tk = tcand[np.arange(len(tcand)), k]
                    take = tk < tbest
                    tbest = np.where(take, tk, tbest)
                    sbest = np.where(take, sigma_rows[k], sbest)

                if len(obb):
                    # ray dir in each box frame; slab test per axis
                    dxp = dx * bct + dy * bst
                    dyp = -dx * bst + dy * bct
                    t1 = (-hx - oxp) / dxp
                    t2 = (hx - oxp) / dxp
                    tn = np.minimum(t1, t2)
                    tf = np.maximum(t1, t2)
                    t1 = (-hy - oyp) / dyp
                    t2 = (hy - oyp) / dyp
                    np.maximum(tn, np.minimum(t1, t2), out=tn)
                    np.minimum(tf, np.maximum(t1, t2), out=tf)
                    t1 = (-hz - ozp) / dz
                    t2 = (hz - ozp) / dz
                    np.maximum(tn, np.minimum(t1, t2), out=tn)
                    np.minimum(tf, np.maximum(t1, t2), out=tf)
                    tn = np.where((tf >= tn) & (tf > 0),
                                  np.maximum(tn, 0.0), np.inf)
                    consider(tn, obb[:, 7])
                if len(cy_):
                    a = dx * dx + dy * dy            # [A,1]
                    b = 2.0 * (dx * qx + dy * qy)    # [A,K]
                    disc = b * b - 4.0 * a * cc
                    root = np.sqrt(np.maximum(disc, 0.0))
                    ts = (-b - root) / (2.0 * a)
                    zhit = o[2] + ts * dz
                    ok = (disc > 0) & (ts > 0) \
                        & (zhit >= cy_[:, 2]) & (zhit <= cy_[:, 3])
                    ts = np.where(ok, ts, np.inf)
                    # top cap (rays looking down onto short cylinders)
                    tc = (cy_[:, 3] - o[2]) / dz
                    capx = o[0] + tc * dx - cy_[:, 0]
                    capy = o[1] + tc * dy - cy_[:, 1]
                    okc = (tc > 0) & (capx ** 2 + capy ** 2
                                      <= cy_[:, 4] ** 2)
                    consider(np.minimum(ts, np.where(okc, tc, np.inf)),
                             cy_[:, 5])
                if len(sp):
                    b = 2.0 * (dc @ sq.T)            # [A,S]
                    disc = b * b - 4.0 * sc
                    root = np.sqrt(np.maximum(disc, 0.0))
                    ts = (-b - root) * 0.5
                    consider(np.where((disc > 0) & (ts > 0), ts, np.inf),
                             sp[:, 4])
                tb[a0:a0 + 4096] = tbest
                sig[a0:a0 + 4096] = sbest
        ground_hit = tgnd <= tb               # ground won (vs any primitive)
        t = np.minimum(tgnd, tb)
        hit = (t > 2.0) & (t < max_range)
        pts = o + t[hit, None] * d[hit]
        if terrain_seed is not None:
            gh = ground_hit[hit]
            pts[gh, 2] += SyntheticPairs._terrain(
                terrain_seed, pts[gh, :2])
        # world-anchored surface relief: per-surface amplitude (vegetation
        # thick shells, walls brick-scale, ground gravel-scale) applied to
        # a deterministic f(world position) field, so BOTH scans displace
        # the same world surface identically — the view-consistent local
        # signature descriptors train on (see _world_texture docstring)
        amp = np.where(ground_hit[hit], np.float32(0.15), sig[hit])
        if terrain_seed is not None:
            pts = pts + SyntheticPairs._world_texture(
                terrain_seed + 1, pts) * amp[:, None]
        # plus plain per-scan sensor noise
        pts = pts + rng.normal(0, 1.0, pts.shape) * 0.02
        # to sensor frame (yaw-only pose)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        return ((pts - o) @ R).astype(np.float32)

    def __getitem__(self, idx):
        xyz0, xyz1, M2, d = self._build_scene(idx)
        xyz0, xyz1, trans, search = augment_pair(
            xyz0, xyz1, M2, self.randg,
            random_rotation=self.random_rotation, random_scale=False,
            search_voxel_size=self.matching_search_voxel_size)
        return {
            "xyz0": xyz0, "xyz1": xyz1, "T_gt": trans,
            "frame_distance": max(1, int(round(d))),
            "search_radius": search,
        }

    def _item_dist(self, idx, rng) -> float:
        """Sensor separation (m) of item `idx`; the continuous dataset
        draws it from its extension schedule (datasets.py)."""
        return float(self.dist)

    def _build_scene(self, idx):
        """Raycast one deterministic scene -> (xyz0, xyz1, M2, d)."""
        rng = np.random.default_rng(self.seed0 + idx)
        d = self._item_dist(idx, rng)
        scene = self.make_scene(
            rng, d, keepout=((0.0, 0.0), (d, 0.0)),
            facade_len_scale=self.facade_len_scale,
            facade_gap_scale=self.facade_gap_scale)
        # relative pose grows with travel distance (curving-road model)
        frac = min(1.0, max(d / 45.0, self.POSE_FRACTION_FLOOR))
        yaw = rng.uniform(-0.3, 0.3) * frac
        c, s = np.cos(yaw), np.sin(yaw)
        pos0 = np.eye(4)
        pos1 = np.eye(4)
        pos1[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pos1[:3, 3] = (d, rng.uniform(-2, 2) * frac, 0)
        n_az = max(64, self.n_points // 64)

        def scan(pose, pyaw):
            pts = self.raycast_scan(rng, pose[:3, 3], pyaw, scene,
                                    n_az=n_az,
                                    terrain_seed=self.seed0 + 6000 + idx)
            if len(pts) > self.n_points:
                pts = pts[rng.permutation(len(pts))[: self.n_points]]
            return pts

        xyz0, xyz1 = scan(pos0, 0.0), scan(pos1, yaw)
        M2 = np.linalg.inv(pos1) @ pos0
        return xyz0, xyz1, M2, d


def collate_items(items, point_capacity: int) -> RawBatch:
    """Pad items into one RawBatch of CPU tensors (move with `.to`)."""
    B, P = len(items), point_capacity
    xyz0 = np.zeros((B, P, 3), np.float32)
    xyz1 = np.zeros((B, P, 3), np.float32)
    n0 = np.zeros(B, np.int32)
    n1 = np.zeros(B, np.int32)
    T = np.zeros((B, 4, 4), np.float32)
    fd = np.zeros(B, np.int32)
    sr = np.zeros(B, np.float32)
    for b, it in enumerate(items):
        a, c = it["xyz0"][:P], it["xyz1"][:P]
        xyz0[b, :len(a)] = a
        xyz1[b, :len(c)] = c
        n0[b], n1[b] = len(a), len(c)
        T[b] = it["T_gt"]
        fd[b] = it["frame_distance"]
        sr[b] = it["search_radius"]
    return RawBatch(*(torch.from_numpy(x) for x in (xyz0, n0, xyz1, n1, T,
                                                    fd, sr)))
