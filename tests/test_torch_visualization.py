"""eyoc_tpu_torch.utils.visualization against eyoc_tpu.utils.visualization,
both numpy, on numpy seed 0 inputs: the Spectral colour map (inside and
outside [0, 1]), the PCA embedding, get_colored_point_cloud_feature, and
the PLY writer's bytes (with and without colours) and reader, bit-equal;
the errors for bad shapes and an unknown method. t-SNE needs sklearn and is
not run here."""

import numpy as np
import pytest
import torch

from eyoc_tpu.utils import visualization as J
from eyoc_tpu_torch.utils import visualization as T


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_color_map_and_embedding_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 1000), [0.0, 0.1, 1.0]])
    assert np.array_equal(J.get_color_map(x), T.get_color_map(x))
    feats = rng.normal(size=(400, 32)).astype(np.float32)
    e = T.embed_to_unit_interval(feats)
    assert np.array_equal(J.embed_to_unit_interval(feats), e)
    assert e.min() == 0.0 and e.max() == 1.0
    xyz = rng.normal(size=(400, 3))
    for a, b in zip(J.get_colored_point_cloud_feature(xyz, feats),
                    T.get_colored_point_cloud_feature(xyz, feats)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown embedding"):
        T.embed_to_unit_interval(feats, method="umap")
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        T.embed_to_unit_interval(feats[0])


@pytest.mark.parametrize("colored", [True, False])
def test_ply_bytes_and_round_trip(tmp_path, colored):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(257, 3)) * 10
    colors = rng.random((257, 3)) if colored else None
    J.write_ply(str(tmp_path / "j.ply"), xyz, colors)
    T.write_ply(str(tmp_path / "t.ply"), xyz, colors)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    xj, cj = J.read_ply(str(tmp_path / "t.ply"))
    xt, ct = T.read_ply(str(tmp_path / "t.ply"))
    assert np.array_equal(xj, xt)
    assert np.array_equal(xt, xyz.astype(np.float32))
    if colored:
        assert np.array_equal(cj, ct)
        assert np.abs(ct - colors).max() <= 0.5 / 255 + 1e-12
    else:
        assert cj is None and ct is None
    with pytest.raises(ValueError, match="xyz"):
        T.write_ply(str(tmp_path / "bad.ply"), xyz[:, :2])
    with pytest.raises(ValueError, match="colors"):
        T.write_ply(str(tmp_path / "bad.ply"), xyz, np.zeros((3, 3)))
