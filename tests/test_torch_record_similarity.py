"""eyoc_tpu_torch.tools.record_similarity against
eyoc_tpu.tools.record_similarity on the CPU (K6 by its plain version, JAX
under jax.jit):

- `dist_similarity_samples` on numpy seed 0 draws with correspondences
  whose indices fall outside [0, N) where they are invalid: d0 / d1 within
  1e-6 relative, cos within 1e-6, compared only under `valid` (there K6
  reads a zero row and jnp.take fills NaN, so the values differ there by
  design); `valid` itself bit-equal;
- `build_similarity_tables` bit-equal on logs of 6 frame buckets (numpy
  seed 0), `save_similarity_tables`' npz read back bit-equal by both
  packages, and read by the port's `load_similarity_tables` into the same
  maps as JAX's; the tables drive the port's `spatial_filter_mask` as
  tests/test_record_similarity.py drives JAX's (near kept, far dropped);
- `make_record_step` on JAX's TestRecordStepEndToEnd configuration
  (SimpleNetBNE, conv1 k = 3, 8 outputs, 2048 raw points, caps from
  voxel_capacity 1024) with JAX's init carried across by models/convert.py,
  f32 convolutions on both sides: valid bit-equal, d0 / d1 within 1e-6
  relative and cos within 1e-4 (features within 1e-4, as
  test_torch_slice.py) under valid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.tools import record_similarity as J
from eyoc_tpu_torch.tools import record_similarity as T


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def under_valid(j, t, v, rtol_d=1e-6, atol_cos=1e-6):
    d0j, d1j, cj, vj = (np.asarray(x) for x in j)
    d0t, d1t, ct, vt = (x.numpy() for x in t)
    assert np.array_equal(vj, vt) and np.array_equal(vt, v)
    assert v.any() and (~v).any()
    np.testing.assert_allclose(d0t[v], d0j[v], rtol=rtol_d, atol=0)
    np.testing.assert_allclose(d1t[v], d1j[v], rtol=rtol_d, atol=0)
    np.testing.assert_allclose(ct[v], cj[v], rtol=0, atol=atol_cos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_samples_match_jax_under_valid(dtype):
    rng = np.random.default_rng(0)
    x0 = (rng.normal(size=(50, 3)) * 20).astype(np.float32)
    x1 = (rng.normal(size=(60, 3)) * 20).astype(np.float32)
    f0 = rng.normal(size=(50, 8)).astype(np.float32)
    f1 = rng.normal(size=(60, 8)).astype(np.float32)
    v = rng.uniform(size=40) < 0.7
    i0 = np.where(v, rng.integers(0, 50, 40), 50).astype(np.int32)
    i1 = np.where(v, rng.integers(0, 60, 40),
                  rng.choice([-1, 60, 99], 40)).astype(np.int32)
    jf0, jf1 = (jnp.asarray(f).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for f in (f0, f1))
    want = jax.jit(J.dist_similarity_samples)(
        jnp.asarray(x0), jnp.asarray(x1), jf0, jf1, jnp.asarray(i0),
        jnp.asarray(i1), jnp.asarray(v))
    args = (torch.from_numpy(x0), torch.from_numpy(x1),
            torch.from_numpy(f0).to(dtype), torch.from_numpy(f1).to(dtype),
            torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(v))
    got = T.dist_similarity_samples(*args)
    under_valid(want, got, v)
    plain = T.dist_similarity_samples_plain(*args)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    # every invalid index here is out of range: a zero row, range 0
    assert (got[0].numpy()[~v] == 0).all() and (got[1].numpy()[~v] == 0).all()


def logs(seed=0, n_per=3000):
    rng = np.random.default_rng(seed)
    out = []
    for fd in (2, 7, 12, 17, 22, 27):
        d0 = rng.uniform(0, 60, n_per)
        d1 = np.clip(d0 + rng.normal(0, 8, n_per), 0, 80)
        mn = np.minimum(d0, d1)
        out.append((fd, d0, d1, np.where(mn < 20, 0.9, 0.1)
                    + rng.normal(0, 0.01, n_per)))
    return out


def test_tables_bit_equal_and_drive_the_filter(tmp_path, monkeypatch):
    import eyoc_tpu.ops.matching as JM
    import eyoc_tpu_torch.ops.matching as TM

    L = logs()
    for min_count in (5, 20, 200):
        tj = J.build_similarity_tables(L, min_count=min_count)
        tt = T.build_similarity_tables(L, min_count=min_count)
        assert len(tt) == 6
        for a, b in zip(tj, tt):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tables = T.build_similarity_tables(L, min_count=5)
    J.save_similarity_tables(str(tmp_path / "j_distSimPlot.npz"), tables)
    T.save_similarity_tables(str(tmp_path / "t_distSimPlot.npz"), tables)
    for name in ("j", "t"):
        raw = np.load(tmp_path / f"{name}_distSimPlot.npz",
                      allow_pickle=True)["res"].tolist()
        for a, b in zip(raw, tables):
            assert np.array_equal(np.asarray(a), b)
    monkeypatch.setattr(JM, "_ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(TM, "_ASSET_DIR", str(tmp_path))
    sj = JM.load_similarity_tables("t")
    st = TM.load_similarity_tables("t")
    assert np.array_equal(np.asarray(sj.maps), st.maps.numpy())
    near = torch.tensor([[[3.0, 0, 0], [10, 0, 0]]])
    far = torch.tensor([[[40.0, 0, 0], [45, 0, 0]]])
    fd = torch.tensor([12], dtype=torch.int32)
    keep = [TM.spatial_filter_mask(x, x, spatial_filter="Similarity",
                                   similarity=st, similarity_thresh=0.6,
                                   frame_distance=fd) for x in (near, far)]
    assert bool(keep[0].all()) and not bool(keep[1].any())


@pytest.fixture
def _f32_convs():
    from eyoc_tpu.sparse import brick_conv as jbc
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def test_record_step_matches_jax(_f32_convs):
    from eyoc_tpu.config import Config, build_parser
    from eyoc_tpu.data.datasets import SyntheticPairDataset
    from eyoc_tpu.data.loader import DataLoader
    from eyoc_tpu.models import init_unet, load_model
    from eyoc_tpu.training.steps import StepBuilder
    from eyoc_tpu.training.trainer import build_step_config
    from eyoc_tpu_torch.config import Config as TConfig
    from eyoc_tpu_torch.config import build_parser as tbuild_parser
    from eyoc_tpu_torch.models import ResUNet
    from eyoc_tpu_torch.models import load_model as tload_model
    from eyoc_tpu_torch.models.convert import params_from_jax
    from eyoc_tpu_torch.training.pipeline import RawBatch
    from eyoc_tpu_torch.training.trainer import \
        build_step_config as tbuild_step_config

    over = dict(model="SimpleNetBNE", conv1_kernel_size=3, model_n_out=8,
                voxel_size=0.3, raw_point_capacity=2048, voxel_capacity=1024,
                knn_tile=128, supervised=True)
    cfg = Config(vars(build_parser().parse_args([])))
    cfg.update(over)
    spec = load_model(cfg.model)
    params, bn_state = jax.jit(lambda key: init_unet(
        spec, key, 1, cfg.model_n_out, cfg.conv1_kernel_size))(
        jax.random.PRNGKey(0))
    loader = DataLoader(
        SyntheticPairDataset("train", cfg, n_pairs=2,
                             n_points=cfg.raw_point_capacity, dist=1.0),
        1, cfg.raw_point_capacity, shuffle=False)
    step = J.make_record_step(StepBuilder(build_step_config(cfg, spec)))
    batch = next(iter(loader))
    want = step(params, bn_state, batch)

    tcfg = TConfig(vars(tbuild_parser().parse_args([])))
    tcfg.update(over)
    tspec = tload_model(tcfg.model)
    model = ResUNet(tspec, 1, 8, 3, dtype=torch.float32)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, bn_state)))
    _, ecfg = tbuild_step_config(tcfg, tspec)
    tbatch = RawBatch(*(torch.from_numpy(np.asarray(x)) for x in batch))
    got = T.make_record_step(ecfg)(model, tbatch)
    v = np.asarray(want[3])
    under_valid(want, got, v, atol_cos=1e-4)
    assert (np.abs(got[2].numpy()[v]) <= 1.0 + 1e-5).all()


def test_main_on_a_kitti_tree(tmp_path, monkeypatch):
    """`main` on the CPU over tests/test_torch_kitti_data.py's KITTI tree
    (scans within 18 m) with an imported SimpleNetBNE/16 checkpoint
    (test_torch_test_cli.py's): the npz it writes holds the tables that
    the same loader, weights and record step give when composed by hand,
    bit for bit; one step time a pair; without a device it raises for want
    of CUDA."""
    from eyoc_tpu_torch.config import get_config
    from eyoc_tpu_torch.data import datasets as TD
    from eyoc_tpu_torch.data.loader import make_data_loader
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.tools import import_torch_ckpt
    from eyoc_tpu_torch.training.checkpoint import load_weights_only
    from eyoc_tpu_torch.training.trainer import build_step_config
    from test_torch_kitti_data import kitti_tree
    from test_torch_test_cli import reference_checkpoint

    root = kitti_tree(tmp_path / "kitti", radius=18.0)
    split = tmp_path / "split_00.txt"
    split.write_text("00\n")
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))
    pth = str(tmp_path / "best_val_checkpoint.pth")
    reference_checkpoint(pth)
    out = str(tmp_path / "imported")
    import_torch_ckpt.main(["--input", pth, "--output_dir", out, "--name",
                            "best_val_checkpoint"])
    ckpt = f"{out}/best_val_checkpoint"
    npz = str(tmp_path / "rec_distSimPlot.npz")
    argv = ["--checkpoint", ckpt, "--kitti_root", root, "--out", npz,
            "--model", "SimpleNetBNE", "--pair_min_dist", "1",
            "--pair_max_dist", "4", "--max_pairs", "2", "--min_count", "2"]
    over = dict(model_n_out=16, conv1_kernel_size=3, raw_point_capacity=4096,
                voxel_capacity=1024, window_bits="7,7,6")
    tables, secs = T.main(argv + ["--device", "cpu"], config_overrides=over)
    assert len(secs) == 2 and all(s > 0 for s in secs)
    raw = np.load(npz, allow_pickle=True)["res"].tolist()
    for a, b in zip(raw, tables):
        assert np.array_equal(np.asarray(a), b)

    config = get_config([])
    config.update(dict(dataset="KittiNFramePairDataset", model="SimpleNetBNE",
                       voxel_size=0.3, pair_min_dist=1, pair_max_dist=4,
                       kitti_root=root, supervised=True, **over))
    spec = load_model("SimpleNetBNE")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 16, 3,
                      device="cpu")
    load_weights_only(ckpt, model)
    step = T.make_record_step(build_step_config(config, spec)[1])
    logs = []
    for i, batch in enumerate(make_data_loader(config, "train", 1,
                                               shuffle=False, device="cpu")):
        if i == 2:
            break
        d0, d1, cos, v = (x.numpy() for x in step(model, batch))
        assert v.any()
        logs.append((int(batch.frame_distance[0]), d0[v], d1[v], cos[v]))
    for a, b in zip(T.build_similarity_tables(logs, min_count=2), tables):
        assert np.array_equal(a, b)
    assert (tables[0] != 0).any()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(argv)
