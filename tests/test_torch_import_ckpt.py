"""eyoc_tpu_torch.tools.import_torch_ckpt against the JAX importer and its
goldens:

- reference-style checkpoints (the JAX tests' `_deterministic_params`,
  its init_unet under one jit: JAX init + non-trivial BN statistics,
  exported by the JAX `params_to_torch_state_dict`) imported by the port
  and run through the port's eval forward in f32 meet both committed
  feature goldens (tests/golden/import_torch_features.npz, SimpleNetBNE/16;
  import_torch_resunetbn2c_features.npz, ResUNetBN2C/32 with conv1 k = 5)
  at cosine > 0.999 on every live row, the dead rows (norm <= 1e-6: a ReLU-
  dead row L2-normalizes to zero) zero in both within 1e-6, as
  tests/test_import_torch.py:284-365 holds the JAX importer;
- the port's `params_to_torch_state_dict` equal to JAX's on the same numpy
  params, key for key (in order) and bit for bit, for a BN, an IN and a
  SimpleNet spec;
- `write_test_config` writes the JAX tool's config.json for the same
  checkpoint;
- `save_imported` then `training.checkpoint.load_weights_only` round-trips
  every tensor, and `main` imports ResUNetExpBN2C (a SimpleNetBNE
  checkpoint taken for one raises); a checkpoint whose
  config torch.load(weights_only=True) refuses goes through the zip reader.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from eyoc_tpu.models import init_unet as jinit
from eyoc_tpu.models import load_model as jload
from eyoc_tpu.tools import import_torch_ckpt as J
from eyoc_tpu_torch.models import ResUNet, init_unet, load_model
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.tools import import_torch_ckpt as T
from eyoc_tpu_torch.training.checkpoint import load_weights_only
from eyoc_tpu_torch.training.pipeline import preprocess_clouds
from test_import_torch import _save_reference_style

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _deterministic_params(spec_name, n_out, k1):
    """tests/test_import_torch.py's `_deterministic_params` (PRNGKey(42),
    BN statistics + 0.25 * arange / C) with the init under one jit (eager,
    it compiles every op apart: ~12 s for ResUNetBN2C)."""
    spec = jload(spec_name)
    params, bn = jax.jit(lambda key: jinit(spec, key, 1, n_out, k1))(
        jax.random.PRNGKey(42))
    bn = jax.tree_util.tree_map(
        lambda x: x + 0.25 * np.arange(x.shape[0], dtype=np.float32) /
        max(1, x.shape[0]), numpy_tree(bn))
    return spec, numpy_tree(params), bn


def port_features(state, info, seed, caps):
    """The port's eval forward (f32) of an imported state on the goldens'
    cloud: 400 points uniform in [-6, 6]^3 (RandomState(seed))."""
    model = ResUNet(load_model(info["model"]), 1, info["model_n_out"],
                    info["conv1_kernel_size"], dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    pts = np.random.RandomState(seed).uniform(-6, 6, (1, 400, 3)).astype(
        np.float32)
    vox, pyr = preprocess_clouds(torch.from_numpy(pts),
                                 torch.tensor([400], dtype=torch.int32),
                                 caps=caps, voxel_size=0.3,
                                 window_bits=(8, 8, 7))
    return model(pyr).numpy(), vox.mask[0].numpy()


@pytest.mark.parametrize("golden,spec,n_out,k1,seed,caps", [
    ("import_torch_features.npz", "SimpleNetBNE", 16, 3, 0,
     (512, 256, 256)),
    ("import_torch_resunetbn2c_features.npz", "ResUNetBN2C", 32, 5, 1,
     (512, 256, 256, 256)),
])
def test_imported_matches_golden(tmp_path, golden, spec, n_out, k1, seed,
                                 caps):
    _, params, bn = _deterministic_params(spec, n_out, k1)
    path = _save_reference_style(tmp_path, params, bn, spec, n_out, k1)
    state, info = T.import_checkpoint(path)
    assert (info["model"], info["model_n_out"], info["conv1_kernel_size"],
            info["epoch"]) == (spec, n_out, k1, 7)
    feats, mask = port_features(state, info, seed, caps)
    g = np.load(os.path.join(GOLDEN, golden))
    assert (mask == g["mask"]).all()
    a, b = feats[mask], g["feats"][g["mask"]]
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    live = (na > 1e-6) | (nb > 1e-6)
    cos = np.sum(a[live] * b[live], -1) / (na[live] * nb[live] + 1e-12)
    assert live.sum() > 0 and float(cos.min()) > 0.999
    np.testing.assert_allclose(a[~live], b[~live], atol=1e-6)


@pytest.mark.parametrize("spec,n_out,k1", [("ResUNetBN2C", 32, 5),
                                           ("ResUNetIN2", 16, 3),
                                           ("SimpleNetBNE", 16, 3)])
def test_exporter_matches_jax(spec, n_out, k1):
    _, params, bn = _deterministic_params(spec, n_out, k1)
    want = J.params_to_torch_state_dict(params, bn)
    got = T.params_to_torch_state_dict(params_from_jax(params, bn))
    assert list(got) == list(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.array_equal(g, w), k
    # and back: the importer lands every tensor where params_from_jax does
    model = ResUNet(load_model(spec), 1, n_out, k1, dtype=torch.float32)
    back = T.torch_state_dict_to_params(want, model)
    ref = params_from_jax(params, bn)
    assert set(back) == set(ref)
    for k in ref:
        assert torch.equal(back[k], ref[k]), k


def test_write_test_config_matches_jax(tmp_path):
    _, params, bn = _deterministic_params("SimpleNetBNE", 16, 3)
    path = _save_reference_style(tmp_path, params, bn, "SimpleNetBNE", 16, 3)
    ckpt = torch.load(path, weights_only=False)
    ckpt["config"].update(voxel_capacity=256, eval_sample_points=128,
                          not_a_flag=1, use_RANSAC=False)
    torch.save(ckpt, path)
    info = {"model": "SimpleNetBNE", "model_n_out": 16,
            "conv1_kernel_size": 3}
    out = tmp_path / "out"
    out.mkdir()
    with open(J.write_test_config(str(out), path, info)) as f:
        want = json.load(f)
    with open(T.write_test_config(str(out), path, info)) as f:
        got = json.load(f)
    assert got == want and list(got) == list(want)
    assert got["voxel_capacity"] == 256 and "not_a_flag" not in got


class _EasyDict(dict):
    """A config class that torch.load(weights_only=True) refuses, as the
    reference's easydict."""


def test_save_imported_round_trip_and_main(tmp_path, capsys):
    _, params, bn = _deterministic_params("SimpleNetBNE", 16, 3)
    path = _save_reference_style(tmp_path, params, bn, "SimpleNetBNE", 16, 3)
    ckpt = torch.load(path, weights_only=False)
    ckpt["config"] = _EasyDict(ckpt["config"])
    torch.save(ckpt, path)
    with pytest.raises(Exception):
        torch.load(path, weights_only=True)
    out = str(tmp_path / "imported")
    T.main(["--input", path, "--output_dir", out, "--name",
            "best_val_checkpoint", "--write_test_config"])
    assert "imported SimpleNetBNE" in capsys.readouterr().out
    state, info = T.import_checkpoint(path)
    model = ResUNet(load_model("SimpleNetBNE"), 1, 16, 3,
                    dtype=torch.float32)
    load_weights_only(os.path.join(out, "best_val_checkpoint"), model)
    loaded = model.state_dict()
    assert set(loaded) == set(state)
    for k, v in state.items():
        assert torch.equal(loaded[k], v), k
    with open(os.path.join(out, "best_val_checkpoint.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 7 and meta["config"]["model"] == "SimpleNetBNE"
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["model"] == "SimpleNetBNE"
    # a SimpleNetBNE checkpoint is no ResUNetExpBN2C
    with pytest.raises(ValueError, match="missing key|kernel shape"):
        T.main(["--input", path, "--output_dir", out, "--model",
                "ResUNetExpBN2C"])
    # ResUNetExpBN2C imports (its norm{l}_{r} / block{l}_{r} keys): a
    # reference-style checkpoint of the port's init, exported by the port,
    # comes back bit for bit
    exp = init_unet(load_model("ResUNetExpBN2C"), torch.Generator()
                    .manual_seed(1), 1, 32, 5, device="cpu")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          T.params_to_torch_state_dict(exp.state_dict()).items()}
    assert "norm2_tr_2.bn.running_var" in sd and "block1_2.conv1.kernel" in sd
    exp_path = str(tmp_path / "exp.pth")
    torch.save({"epoch": 1, "state_dict": sd,
                "config": {"model": "ResUNetExpBN2C"}}, exp_path)
    T.main(["--input", exp_path, "--output_dir", str(tmp_path / "exp")])
    assert "imported ResUNetExpBN2C" in capsys.readouterr().out
    back = ResUNet(load_model("ResUNetExpBN2C"), dtype=torch.float32)
    load_weights_only(str(tmp_path / "exp" / "checkpoint"), back)
    for k, v in exp.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_missing_key_raises():
    _, params, bn = _deterministic_params("SimpleNetBNE", 16, 3)
    sd = J.params_to_torch_state_dict(params, bn)
    del sd["final.kernel"]
    model = ResUNet(load_model("SimpleNetBNE"), 1, 16, 3,
                    dtype=torch.float32)
    with pytest.raises(ValueError, match="final.kernel"):
        T.torch_state_dict_to_params(sd, model)
