"""Feature-colored point-cloud visualization (host-side, dependency-light;
a copy of eyoc_tpu/utils/visualization.py: numpy only, the same bits).

Capability parity with the reference's `util/visualization.py:1-49`
(`get_colored_point_cloud_feature`: embed per-point descriptors to 1-D,
map through a spectral colormap, and emit a renderable colored cloud).
The reference renders via Open3D sphere meshes and embeds with sklearn
TSNE; neither is a hard dependency here:

- embedding defaults to 1-D PCA (numpy SVD — deterministic and ~1000x
  faster than TSNE at typical cloud sizes); ``method="tsne"`` uses
  sklearn when importable and raises otherwise,
- output is a binary-little-endian PLY file (colored points), readable
  by Open3D/MeshLab/CloudCompare — the functional equivalent of the
  reference's sphere-mesh trick, which exists only to give points
  screen area in Open3D's renderer,
- the spectral colormap is a fixed 11-anchor LUT matching matplotlib's
  ``Spectral`` anchors, so matplotlib is optional too.

All functions take numpy arrays (features come off the card with one
``.cpu().numpy()``).
"""

from __future__ import annotations

import struct

import numpy as np

# matplotlib's Spectral colormap anchor points (colorbrewer 11-class
# Spectral), interpolated linearly — identical anchors, so colors match
# the reference's `plt.cm.Spectral(x)` to within interpolation error.
_SPECTRAL_ANCHORS = np.array(
    [
        (158, 1, 66),
        (213, 62, 79),
        (244, 109, 67),
        (253, 174, 97),
        (254, 224, 139),
        (255, 255, 191),
        (230, 245, 152),
        (171, 221, 164),
        (102, 194, 165),
        (50, 136, 189),
        (94, 79, 162),
    ],
    dtype=np.float64,
) / 255.0


def get_color_map(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] -> RGB via the Spectral colormap.

    Mirrors reference `util/visualization.py:9-11` without matplotlib.
    Returns [N, 3] float64 in [0, 1].
    """
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    pos = x * (len(_SPECTRAL_ANCHORS) - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, len(_SPECTRAL_ANCHORS) - 1)
    frac = (pos - lo)[..., None]
    return _SPECTRAL_ANCHORS[lo] * (1.0 - frac) + _SPECTRAL_ANCHORS[hi] * frac


def embed_to_unit_interval(features: np.ndarray, method: str = "pca") -> np.ndarray:
    """Embed [N, D] per-point descriptors to scalars in [0, 1].

    ``pca`` (default): first principal component — deterministic, no deps.
    ``tsne``: sklearn TSNE with the reference's hyperparameters
    (`util/visualization.py:40-49`); requires sklearn.
    """
    features = np.asarray(features, dtype=np.float64)
    if features.ndim != 2:
        raise ValueError(f"expected [N, D] features, got {features.shape}")
    if method == "pca":
        centered = features - features.mean(axis=0, keepdims=True)
        # leading right-singular vector via economical SVD
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        scalars = centered @ vt[0]
    elif method == "tsne":
        from sklearn.manifold import TSNE  # optional dependency

        tsne = TSNE(
            n_components=1, verbose=1, perplexity=40, max_iter=300, random_state=0
        )
        scalars = np.squeeze(tsne.fit_transform(features))
    else:
        raise ValueError(f"unknown embedding method: {method!r}")
    lo, hi = float(scalars.min()), float(scalars.max())
    return (scalars - lo) / max(hi - lo, 1e-12)


def get_colored_point_cloud_feature(
    xyz: np.ndarray, features: np.ndarray, method: str = "pca"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-point descriptor visualization colors.

    Reference `util/visualization.py:30-37` builds an Open3D sphere mesh;
    here the equivalent deliverable is (xyz [N, 3], rgb [N, 3] in [0, 1])
    ready for `write_ply`.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    colors = get_color_map(embed_to_unit_interval(features, method=method))
    return xyz, colors


def write_ply(path: str, xyz: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write a binary-little-endian PLY point cloud (colors in [0, 1])."""
    xyz = np.asarray(xyz, dtype=np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"expected [N, 3] xyz, got {xyz.shape}")
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.shape != (n, 3):
            raise ValueError(f"expected [{n}, 3] colors, got {colors.shape}")
        rgb = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(xyz.astype("<f4").tobytes())
        else:
            row = struct.Struct("<fffBBB")
            f.write(b"".join(
                row.pack(*map(float, xyz[i]), *map(int, rgb[i]))
                for i in range(n)
            ))


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read back a PLY written by `write_ply` (xyz, colors or None)."""
    with open(path, "rb") as f:
        n = 0
        has_color = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.frombuffer(f.read(dt.itemsize * n), dtype=dt)
            return rec["xyz"].copy(), rec["rgb"].astype(np.float64) / 255.0
        xyz = np.frombuffer(f.read(12 * n), dtype="<f4").reshape(n, 3)
        return xyz.copy(), None
