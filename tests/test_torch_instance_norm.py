"""The instance-norm family's eval forward: K20 `masked_instance_norm`
(sparse/norm.py, csrc/instance_norm.cu) and the IN specs of
eyoc_tpu_torch.models against eyoc_tpu, on the same numpy inputs.

- masked_instance_norm_plain against JAX masked_instance_norm_fb (the rows
  of a cloud are its bricks' 8 cells each, in order) at B = 1 and at B = 3
  with an empty cloud, f32, within NORM_RTOL and NORM_ATOL;
- K20's reformulation (`masked_instance_norm_chunked_plain`: each cloud's
  sums in K7's chunked order, g from 1 / sqrt) against the plain version,
  with the ReLU, the residual add and the pre-ReLU output, in f32 (the
  same tolerance) and bf16 (within BF16_ULPS units in the last place);
- csrc/instance_norm.cu built with g++ against tests/cuda_host/ and run
  through the wrapper's launch code on CPU tensors: one and two channel
  slabs (C = 32, 64, 512), three clouds with an empty one and one of a
  single valid row, every apply variant, the scratch poisoned with NaN,
  the ticket words back at zero and the same bits on a second call; held
  to the plain version within BF16_ULPS;
- the eval forward of narrow IN specs of both families (ResUNetIN-shaped:
  BN top-level norms folded into their convs, IN block norms; SimpleNetIN-
  shaped: every norm IN, conv1_tr's too) against apply_unet(training=False,
  n_clouds=B) at B = 1 (the ResUNet) and 2 (the SimpleNet: two clouds of
  3000 and 1700 points), f32, atol 1e-4 on the unit-norm features, as
  tests/test_torch_models.py holds the BN specs;
- params_from_jax over IN trees (no running statistics), every IN spec of
  eyoc_tpu.models built and converted at full width, an IN model taking
  train mode (its no-grad train forward the eval forward's features: every
  norm IN, so batch and eval statistics are the same), and
  api.extract_features running an IN model.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models import MODELS as JMODELS
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.sparse.norm import masked_instance_norm_fb
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch import api
from eyoc_tpu_torch.models import ResUNet, UNetSpec, init_unet, load_model
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.models.unet import InstanceNorm
from eyoc_tpu_torch.sparse import norm as N
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess
from eyoc_tpu_torch.utils import kernels
from test_torch_sc2_emulated import HOST_HEADERS, host_source


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only wait on each other, and
    stall when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


NORM_ATOL = 1e-5      # f32 normalised values of order 1, two sum orders,
NORM_RTOL = 1e-5      # var = E x^2 - mean^2 cancelling (|mean| ~ 1.3 std)
BF16_ULPS = 1         # bf16 outputs of f32 statistics in two sum orders
                      # (units: `ulps_apart`)
CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)
RES_IN = dict(name="narrow", norm_type="BN", block_norm_type="IN",
              channels=(8, 16, 16), tr_channels=(8, 8, 16))
SIMPLE_IN = dict(name="narrow", norm_type="IN", block_norm_type=None,
                 channels=(8, 16, 16), tr_channels=(8, 8, 16),
                 conv1_tr_kernel=3, conv1_tr_norm=True)


@pytest.fixture
def f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def rows(B, cap, C, seed, empty=(), single=()):
    """x [B cap, C] f32 around a per-channel offset, mask [B cap] (about
    70% valid; clouds in `empty` none, in `single` one row), scale, bias,
    residual."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1.5, (B * cap, C))
         + rng.normal(0, 2, C)).astype(np.float32)
    mask = rng.random(B * cap) < 0.7
    for s in empty:
        mask[s * cap:(s + 1) * cap] = False
    for s in single:
        mask[s * cap:(s + 1) * cap] = False
        mask[s * cap + cap // 2] = True
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    res = np.maximum(rng.normal(0, 1, (B * cap, C)), 0).astype(np.float32)
    res[~mask] = 0
    return x, mask, scale, bias, res


def ulps_apart(got, want):
    """|got - want| in units of the last bf16 place of |want|, or of 2^-8
    of the tensor's largest |want| where that is larger: near zero x g +
    off cancels, and the statistics' f32 rounding is of the operands'
    size, not the result's."""
    got, want = got.float(), want.float()
    floor = max(float(want.abs().max()) * 2.0 ** -8, 2.0 ** -126)
    mag = torch.clamp(want.abs(), min=floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


@pytest.mark.parametrize("B,empty", [(1, ()), (3, (1,))])
def test_plain_matches_jax(B, empty):
    cap, C = 512, 16
    x, mask, scale, bias, _ = rows(B, cap, C, 10 + B, empty)
    fb = x.reshape(B * cap // 8, 8 * C)
    occ8 = mask.reshape(-1, 8)
    bseg = (np.arange(B * cap // 8) // (cap // 8)).astype(np.int32)
    want = jax.jit(masked_instance_norm_fb, static_argnums=3)(
        jnp.asarray(fb), jnp.asarray(occ8), jnp.asarray(bseg), B,
        jnp.asarray(scale), jnp.asarray(bias))
    got = N.masked_instance_norm_plain(
        torch.from_numpy(x), torch.from_numpy(mask), B,
        torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy().reshape(fb.shape),
                               np.asarray(want), rtol=NORM_RTOL,
                               atol=NORM_ATOL)
    for s in empty:
        assert not got[s * cap:(s + 1) * cap].any()


VARIANTS = [dict(), dict(relu=True), dict(relu=True, skip=True),
            dict(residual=True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_reformulation_matches_plain(dtype):
    x, mask, scale, bias, res = rows(3, 1500, 64, 3, empty=(2,))
    t = dict(x=torch.from_numpy(x).to(dtype), mask=torch.from_numpy(mask),
             n_segments=3, scale=torch.from_numpy(scale),
             bias=torch.from_numpy(bias))
    r = torch.from_numpy(res).to(dtype)
    for v in VARIANTS:
        kw = dict(v, residual=r if v.get("residual") else None)
        got = N.masked_instance_norm_chunked_plain(**t, **kw)
        want = N.masked_instance_norm_plain(**t, **kw)
        for g, w in zip(got if v.get("skip") else (got,),
                        want if v.get("skip") else (want,)):
            assert g.dtype == dtype
            if dtype == torch.float32:
                np.testing.assert_allclose(g.numpy(), w.numpy(),
                                           rtol=NORM_RTOL, atol=NORM_ATOL)
            else:
                assert ulps_apart(g, w) <= BF16_ULPS


# ---------------------------------------------------------------- the source


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernel's source")
    out = tmp_path_factory.mktemp("host_instance_norm")
    cpp = out / "instance_norm.cpp"
    cpp.write_text(host_source(
        (kernels.CSRC / "instance_norm.cu").read_text()))
    so = out / "libinstance_norm.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrapper's launch code on the host build: CPU tensors pass the
    CUDA-only checks, the scratch comes poisoned with NaN, the ticket words
    are one zeroed array kept across calls."""
    tickets = torch.zeros(256, dtype=torch.int32)

    def load(name, argtypes, symbol=None):
        fn = getattr(host_lib, f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn
    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)
    monkeypatch.setattr(N, "_k20_scratch", lambda n, x: torch.full(
        (n,), float("nan")))
    return tickets


@pytest.mark.parametrize("B,cap,C,empty,single", [
    (1, 700, 32, (), ()), (3, 300, 64, (1,), (2,)), (2, 100, 512, (), ())])
def test_source_on_host_matches_plain(on_host, B, cap, C, empty, single):
    x, mask, scale, bias, res = rows(B, cap, C, C, empty, single)
    bf = torch.bfloat16
    xt = torch.from_numpy(x).to(bf)
    t = (xt, torch.from_numpy(mask), B, torch.from_numpy(scale),
         torch.from_numpy(bias))
    r = torch.from_numpy(res).to(bf)
    for v in VARIANTS:
        residual = r if v.get("residual") else None
        relu, skip = v.get("relu", False), v.get("skip", False)
        got = N._launch_k20(*t, 1e-5, relu, residual, skip)
        want = N.masked_instance_norm_plain(*t, relu=relu, residual=residual,
                                            skip=skip)
        for g, w in zip(got if skip else (got,), want if skip else (want,)):
            assert g.dtype == bf and torch.isfinite(g.float()).all()
            assert ulps_apart(g, w) <= BF16_ULPS
        assert not on_host.any()                  # tickets back at zero
        again = N._launch_k20(*t, 1e-5, relu, residual, skip)
        for g, a in zip(got if skip else (got,), again if skip else (again,)):
            assert torch.equal(g, a)


def test_wrapper_rejects_what_the_kernel_does_not_take(on_host):
    x, mask, scale, bias, _ = rows(1, 64, 12, 0)
    with pytest.raises(ValueError):
        N._launch_k20(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(mask), 1, torch.from_numpy(scale),
                      torch.from_numpy(bias), 1e-5, False, None, False)


# ---------------------------------------------------------------- the models


_PARAMS = {}


def in_params(spec_kw, seed, out_channels=16):
    """JAX init of an IN spec + perturbed affines and BN statistics, as
    numpy trees (an IN norm's state stays None); one JAX compile a spec."""
    key = (tuple(sorted(spec_kw.items())), seed)
    if key not in _PARAMS:
        _PARAMS[key] = _in_params(spec_kw, seed, out_channels)
    return _PARAMS[key]


def _in_params(spec_kw, seed, out_channels):
    js = JSpec(**spec_kw)
    params, bn = jax.jit(lambda key: jinit(js, key, 1, out_channels, 5))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), params)
    bn = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), bn)
    return js, params, bn


@pytest.mark.parametrize("spec_kw,B", [(RES_IN, 1), (SIMPLE_IN, 2)])
def test_in_forward_matches_jax(f32_convs, spec_kw, B):
    js, params, bn = in_params(spec_kw, 5)
    rng = np.random.default_rng(200 + B)
    xyz = rng.normal(0, 4, (B, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 1700][:B], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    want = jax.jit(lambda p, s, y: apply_unet(
        js, p, s, y, training=False, conv1_kernel_size=5, n_clouds=B)[0])(
        params, bn, jpyr)
    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    got = model(tpyr).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    valid = tpyr.vox_masks[0].numpy()
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=1), 1.0,
                               atol=1e-5)
    assert not got[~valid].any()


def test_params_from_jax_over_in_trees():
    js, params, bn = in_params(RES_IN, 5)
    sd = params_from_jax(params, bn)
    assert "norm1.running_mean" in sd                  # BN top-level norm
    assert "block1.norm1.weight" in sd
    assert not any(k.startswith("block1.norm1.running") for k in sd)
    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5)
    model.load_state_dict(sd, strict=True)
    assert isinstance(model.block2.norm2, InstanceNorm)
    np.testing.assert_array_equal(model.block2.norm2.bias.detach().numpy(),
                                  params["block2"]["norm2"]["bias"])


def test_every_in_spec_builds_and_converts_at_full_width():
    names = [n for n, s in JMODELS.items()
             if "IN" in (s.norm_type, s.block_norm_type)]
    assert len(names) == 11
    rng = np.random.default_rng(0)
    for name in names:
        js = JMODELS[name]
        shapes = jax.eval_shape(lambda key: jinit(js, key, 1, 32, 5),
                                jax.random.PRNGKey(0))
        params, bn = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), shapes)
        spec = load_model(name)
        assert spec == UNetSpec(**vars(js))
        model = ResUNet(spec, 1, 32, 5)
        model.load_state_dict(params_from_jax(params, bn), strict=True)
        n_in = sum(isinstance(m, InstanceNorm) for m in model.modules())
        assert n_in > 0, name


def test_in_model_refuses_train_mode():
    """An IN model no longer refuses train mode (its train forward and
    backward are held against JAX in test_torch_train_model.py): train()
    takes it, a forward there under no_grad runs K20's plain version alone
    and leaves the features of the eval forward's norms; a spec with two
    (norm, block) repeats a level (ResUNetExpBN2C) is no longer refused:
    it builds, in train mode too."""
    model = init_unet(load_model("SimpleNetINE"), torch.Generator()
                      .manual_seed(0), 1, 16, 3, dtype=torch.float32,
                      device="cpu")
    assert not model.training
    assert model.train() is model and model.training
    xyz = np.random.default_rng(9).normal(0, 4, (1, 2000, 3)).astype(
        np.float32)
    _, pyr = tpreprocess(torch.from_numpy(xyz), torch.tensor([2000]),
                         caps=CAPS, voxel_size=0.3, window_bits=BITS)
    with torch.no_grad():
        got = model(pyr, bn_momentum=None)
    np.testing.assert_allclose(got.numpy(), model.embed(pyr).numpy(),
                               rtol=0, atol=1e-5)
    model.eval()
    exp = ResUNet(load_model("ResUNetExpBN2C"))          # repeats == 2
    assert exp.train() is exp and exp.training


def test_extract_features_runs_an_in_model():
    """api.extract_features takes an IN model through `embed` (as the JAX
    api.py:120 takes apply_unet with n_clouds=1): the valid voxels' rows of
    the forward held against JAX above, unit norm."""
    js, params, bn = in_params(SIMPLE_IN, 5)
    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    xyz = np.random.default_rng(7).normal(0, 4, (2500, 3)).astype(np.float32)
    pts, feats = api.extract_features(model, xyz, voxel_size=0.3, caps=CAPS,
                                      window_bits=BITS, device="cpu")
    vox, pyr = tpreprocess(torch.from_numpy(xyz[None]),
                           torch.tensor([2500], dtype=torch.int32),
                           caps=CAPS, voxel_size=0.3, window_bits=BITS)
    mask = vox.mask[0]
    assert pts.shape[0] == int(mask.sum()) > 100
    np.testing.assert_array_equal(pts, vox.xyz[0][mask].numpy())
    np.testing.assert_array_equal(feats, model.embed(pyr)[mask].numpy())
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
