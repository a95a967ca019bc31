"""The port's trainer registry against the JAX package's, on the CPU, with
no train step compiled or run.

(a) build_step_config field by field against eyoc_tpu's (trainer.py:45-98)
    for the default flags and the KITTI EYOC launcher's
    (scripts/train_kitti_EYOC.sh): every TrainConfig and EvalConfig field
    that StepConfig has, and the SC2-PCR configuration, equal.
(b) loop parity: both packages' trainers over the same stub dataset (the
    progressive-extension interface of the synthetic continuous dataset),
    with their train-step factories and valid step replaced by recording
    stubs. A stub step moves every parameter by -lr / 2 in both packages,
    so the labeler syncs do real arithmetic; the valid stub returns a
    scripted hit ratio and RRE per pair. The port starts from the JAX
    trainer's initial weights. Compared: the sequence of steps (step mode,
    lr, micro-batches, the items of each batch, num_updates, whether the
    labeler equals the student), of best-val updates and of checkpoint
    writes (epoch, name, best_val, best_val_epoch), exactly; the labeler's
    and the student's weights at every step (rtol 1e-6, atol 1e-7). For
    HardestContrastive; ContinuousCorrExtension with EMA, with Sync, and
    at iter_size 2; ContinuousHardestContrastive (its best-val reset on an
    extension); CorrespondenceExtension with a frozen labeler from another
    run's directory.
(c) the errors raised before any model is built: an unknown trainer, an
    unknown optimizer, a batch that --dp_devices 2 does not divide (two
    ranks), --multihost without torchrun's environment, a dataset the port
    lacks, a labeler run of another architecture; the registry's names.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from eyoc_tpu import config as jconfig
from eyoc_tpu.data import loader as jloader
from eyoc_tpu.models import load_model as jload_model
from eyoc_tpu.training import trainer as jtrainer
from eyoc_tpu_torch import config as tconfig
from eyoc_tpu_torch.data import loader as tloader
from eyoc_tpu_torch.data.loader import make_data_loader
from eyoc_tpu_torch.models import ResUNet, load_model
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training import trainer as ttrainer

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


KITTI_EYOC = [
    "--dataset", "KittiContinuousFramePairDataset",
    "--trainer", "ContinuousCorrExtensionTrainer", "--model", "ResUNetBN2C",
    "--model_n_out", "32", "--conv1_kernel_size", "5", "--optimizer", "SGD",
    "--lr", "3e-1", "--batch_size", "8", "--iter_size", "1",
    "--max_epoch", "200", "--voxel_size", "0.3", "--use_random_scale",
    "True", "--positive_pair_search_voxel_size_multiplier", "1.5",
    "--hit_ratio_thresh", "0.3", "--exp_gamma", "0.98", "--pair_min_dist",
    "1", "--pair_max_dist", "30", "--use_SC2_PCR", "true",
    "--extension_steps", "0", "--sync_strategy", "EMA", "--ema_decay", "0.2",
    "--percentage", "1.0", "--feature_filter", "None", "--spatial_filter",
    "Similarity", "--filter_radius", "40", "--similarity_thresh", "0.6",
    "--use_sc2_filtering", "true", "--pretraining_dataset", "waymo",
    "--skip_initialization", "false",
]


# -------------------------------------------------------------------- (a)


@pytest.mark.parametrize("argv", [[], KITTI_EYOC], ids=["defaults",
                                                        "kitti_eyoc"])
@pytest.mark.parametrize("kind", ["hardest_contrastive", "hardest_triplet"])
def test_build_step_config_matches_jax(argv, kind):
    jcfg = jconfig.get_config(argv)
    tcfg = tconfig.get_config(argv)
    assert dict(jcfg) == dict(tcfg)
    jsc = jtrainer.build_step_config(jcfg, jload_model(jcfg.model),
                                     loss_kind=kind)
    train, evalc = ttrainer.build_step_config(tcfg, load_model(tcfg.model),
                                              loss_kind=kind)
    for cfg in (train, evalc):
        for f in dataclasses.fields(cfg):
            if f.name == "sc2":
                for g in dataclasses.fields(cfg.sc2):
                    assert getattr(cfg.sc2, g.name) == \
                        getattr(jsc.sc2, g.name), g.name
            elif hasattr(jsc, f.name):
                assert getattr(cfg, f.name) == getattr(jsc, f.name), f.name
            else:
                assert f.name in ("use_ransac", "ransac"), f.name
    assert train.loss_kind == kind


# -------------------------------------------------------------------- (b)


class StubDataset:
    """Four tiny pairs, item i's first coordinate i; the extension
    interface of SyntheticContinuousPairDataset (datasets.py:859-936)."""

    def __init__(self, phase, config, n=4):
        self.phase, self.n = phase, n
        self.FIRST_DIST = config.pair_min_dist
        self.LAST_DIST = config.pair_max_dist
        self.MAX_DIST = self.FIRST_DIST if phase == "train" else self.LAST_DIST
        self.max_epoch = config.max_epoch - 1
        self.last_altered_epoch = 0
        self.supervised = config.supervised

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        xyz = np.zeros((8, 3), np.float32)
        xyz[0, 0] = i
        return {"xyz0": xyz, "xyz1": xyz, "T_gt": np.eye(4, dtype=np.float32),
                "frame_distance": 1, "search_radius": 0.45}

    def reset_seed(self, seed=0):
        pass

    def update_extension_distance(self, epoch):
        expected = int((self.LAST_DIST - self.FIRST_DIST)
                       * (epoch / max(self.max_epoch, 1))) + self.FIRST_DIST
        if expected == self.MAX_DIST:
            return False
        self.MAX_DIST = expected
        return expected

    def is_base_dataset(self):
        return self.MAX_DIST <= 1

    def label_mode(self):
        if self.MAX_DIST <= 1 and self.phase == "train":
            return "identity"
        return "gt" if self.phase != "train" or self.supervised else "none"


# (hit ratio, RRE) of the validation pairs in order, two a validation:
# feat_match_ratio 0.5, 0 (a non-finite RRE skipped), 1, 0.5, 0.5, 1
VALID_SCRIPT = [(0.1, 1.0), (0.01, 1.0), (0.0, 1.0), (0.3, np.nan),
                (0.2, 1.0), (0.3, 2.0), (0.2, 1.0), (0.01, 1.0),
                (0.2, 1.0), (0.01, 1.0), (0.2, 1.0), (0.3, 1.0)]


def base_config(pkg, out_dir, **kw):
    cfg = pkg.Config(vars(pkg.build_parser().parse_args([])))
    cfg.update(dict(
        model="SimpleNetBNE", conv1_kernel_size=3, model_n_out=8,
        batch_size=1, val_batch_size=1, dp_devices=1, raw_point_capacity=8,
        voxel_capacity=256, pair_min_dist=1, pair_max_dist=3, max_epoch=4,
        val_max_iter=2, stat_freq=1, lr=0.1, exp_gamma=0.5,
        sync_strategy="EMA", ema_decay=0.2, out_dir=out_dir))
    cfg.update(kw)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_init(spec, seed, cin, cout, k):
    from eyoc_tpu.models import init_unet
    return jax.jit(lambda key: init_unet(spec, key, cin, cout, k))(
        jax.random.PRNGKey(seed))


def _fast_jax_init(spec, key, cin, cout, k):
    """JAX's init_unet, jitted and cached (seed 0 only, as the trainers)."""
    assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(0)))
    return _jax_init(spec, 0, cin, cout, k)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_model_like(spec_name, cout, k):
    """A port ResUNet holding the JAX trainer's initial weights."""
    spec = jload_model(spec_name)
    params, bn = _jax_init(spec, 0, 1, cout, k)
    model = ResUNet(load_model(spec_name), 1, cout, k, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    return model


def _items(xyz0):
    return tuple(int(v) for v in np.asarray(xyz0)[..., 0, 0].reshape(-1))


def run_jax(name, cfg, log, weights):
    script = iter(VALID_SCRIPT)
    train = jloader.DataLoader(StubDataset("train", cfg), cfg.batch_size, 8,
                               seed=0)
    val = jloader.DataLoader(StubDataset("val", cfg), 1, 8, shuffle=False)
    t = jtrainer.TRAINERS[name](cfg, train, val)

    def factory(mode):
        def step(state, batch, lr):
            n = batch.xyz0.shape[0] if batch.xyz0.ndim == 4 else 1
            same = all(bool((a == b).all()) for a, b in zip(
                jax.tree_util.tree_leaves(state.labeler_params),
                jax.tree_util.tree_leaves(state.params)))
            state = state._replace(params=jax.tree_util.tree_map(
                lambda p: p - 0.5 * lr, state.params))
            log.append(("step", mode, lr, n, _items(batch.xyz0),
                        int(state.num_updates), same))
            weights.append((
                params_from_jax(np_tree(state.params),
                                np_tree(state.bn_state)),
                params_from_jax(np_tree(state.labeler_params),
                                np_tree(state.labeler_bn_state))))
            return state, {"loss": 1.0, "pos_loss": 0.5, "neg_loss": 0.5}
        return step

    def valid(params, bn, batch, key):
        hit, rre = next(script)
        return {"loss": 0.0, "rte": 0.0, "rre": rre, "hit_ratio": hit}

    t._base_step = lambda mode: factory(mode)
    t._extension_step = lambda: factory("extension")
    t._valid_step = valid
    save = t._save

    def logged_save(epoch, name="checkpoint"):
        log.append(("save", epoch, name, t.best_val, t.best_val_epoch))
        save(epoch, name)
    t._save = logged_save
    t.train()
    return t


def run_torch(name, cfg, log, weights):
    script = iter(VALID_SCRIPT)
    train = tloader.DataLoader(StubDataset("train", cfg), cfg.batch_size, 8,
                               seed=0)
    val = tloader.DataLoader(StubDataset("val", cfg), 1, 8, shuffle=False)
    t = ttrainer.TRAINERS[name](cfg, train, val, device="cpu")

    def factory(mode):
        def step(batch, lr):
            n = len(batch) if isinstance(batch, list) else 1
            xyz0 = torch.stack([b.xyz0 for b in batch]) if n > 1 \
                else batch.xyz0
            same = all(torch.equal(a, b) for a, b in zip(
                t.labeler.parameters(), t.model.parameters()))
            with torch.no_grad():
                for p in t.model.parameters():
                    p.sub_(0.5 * lr)
            log.append(("step", mode, lr, n, _items(xyz0.numpy()),
                        t.num_updates, same))
            weights.append(({k: v.clone() for k, v in
                             t.model.state_dict().items()},
                            {k: v.clone() for k, v in
                             t.labeler.state_dict().items()}))
            return {"loss": 1.0, "pos_loss": 0.5, "neg_loss": 0.5}
        return step

    def valid(batch, generator):
        hit, rre = next(script)
        return {"loss": 0.0, "rte": 0.0, "rre": rre, "hit_ratio": hit}

    t._base_step = lambda mode: factory(mode)
    t._extension_step = lambda: factory("extension")
    t._valid_step = valid
    save = t._save

    def logged_save(epoch, name="checkpoint"):
        log.append(("save", epoch, name, t.best_val, t.best_val_epoch))
        save(epoch, name)
    t._save = logged_save
    t.train()
    return t


@pytest.fixture
def same_init(monkeypatch):
    """Both trainers start from the JAX trainer's initial weights."""
    monkeypatch.setattr(jtrainer, "init_unet", _fast_jax_init)
    monkeypatch.setattr(
        ttrainer, "init_unet",
        lambda spec, gen, cin, cout, k, device=None: _jax_model_like(
            spec.name, cout, k))


def assert_same_runs(jlog, tlog, jw, tw):
    assert tlog == jlog
    assert len(tw) == len(jw) == sum(e[0] == "step" for e in jlog)
    for (tm, tl), (jm, jl) in zip(tw, jw):
        for got, want in ((tm, jm), (tl, jl)):
            assert set(got) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                           rtol=1e-6, atol=1e-7, err_msg=k)


SCENARIOS = {
    "HardestContrastive": ("HardestContrastiveLossTrainer", {}),
    "ContinuousCorrExtension_EMA": ("ContinuousCorrExtensionTrainer", {}),
    "ContinuousCorrExtension_Sync": ("ContinuousCorrExtensionTrainer",
                                     dict(sync_strategy="Sync")),
    "ContinuousCorrExtension_iter_size_2": (
        "ContinuousCorrExtensionTrainer", dict(iter_size=2)),
    "ContinuousHardestContrastive": ("ContinuousHardestContrastiveTrainer",
                                     {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_loop_matches_jax(scenario, tmp_path, same_init):
    name, over = SCENARIOS[scenario]
    jlog, tlog, jw, tw = [], [], [], []
    run_jax(name, base_config(jconfig, str(tmp_path / "jax"), **over), jlog,
            jw)
    t = run_torch(name, base_config(tconfig, str(tmp_path / "torch"),
                                    **over), tlog, tw)
    assert_same_runs(jlog, tlog, jw, tw)
    steps = [e for e in tlog if e[0] == "step"]
    saves = [e[2] for e in tlog if e[0] == "save"]
    assert saves.count("checkpoint") == 4 and "best_val_checkpoint" in saves
    for f in ("checkpoint", "best_val_checkpoint"):
        for ext in (".pt", ".json"):
            assert os.path.exists(os.path.join(t.checkpoint_dir, f + ext))
    if name != "HardestContrastiveLossTrainer":
        # a base epoch (identity labels), then the extension
        assert steps[0][1] == "identity" and steps[-1][1] != "identity"
    if name == "ContinuousCorrExtensionTrainer":
        assert [e[5] for e in steps][-1] > 1 or over.get(
            "sync_strategy") == "Sync"
    if scenario.endswith("iter_size_2"):
        assert {e[3] for e in steps} == {2} and len(steps) == 8
    if name == "ContinuousHardestContrastiveTrainer":
        # the best-val reset on each extension saves a best checkpoint at
        # an epoch whose ratio does not beat the one before
        assert saves.count("best_val_checkpoint") >= 3


def test_frozen_labeler_loop_matches_jax(tmp_path, same_init):
    """CorrespondenceExtensionTrainer loads its labeler from a previous run's
    directory (its config.json and checkpoint) and never syncs it."""
    jlog, tlog, jw, tw = [], [], [], []
    for pkg, run, log, w in ((jconfig, run_jax, jlog, jw),
                             (tconfig, run_torch, tlog, tw)):
        lab_dir = str(tmp_path / pkg.__name__ / "labeler")
        run("HardestContrastiveLossTrainer",
            base_config(pkg, lab_dir, max_epoch=1), [], [])
        log.clear()
        w.clear()
        run("CorrespondenceExtensionTrainer",
            base_config(pkg, str(tmp_path / pkg.__name__ / "run"),
                        labeler_dir=lab_dir), log, w)
    assert_same_runs(jlog, tlog, jw, tw)
    steps = [e for e in tlog if e[0] == "step"]
    assert {e[5] for e in steps} == {0}            # never synced
    for _, lab in tw[1:]:                           # nor moved
        for k, v in lab.items():
            assert torch.equal(v, tw[0][1][k]), k
    # the labeler is the labeler run's student after its epoch: 4 steps of
    # -lr / 2 at lr 0.1
    first = _jax_model_like("SimpleNetBNE", 8, 3).state_dict()
    lab = tw[0][1]
    np.testing.assert_allclose(lab["conv1.weight"].numpy(),
                               first["conv1.weight"].numpy() - 0.2,
                               rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------------- (c)


def test_registry_names_match_jax():
    assert sorted(ttrainer.TRAINERS) == sorted(jtrainer.TRAINERS)
    for name in ttrainer.TRAINERS:
        assert ttrainer.get_trainer(name).LOSS_KIND == \
            jtrainer.get_trainer(name).LOSS_KIND
    with pytest.raises(ValueError, match="unknown trainer 'NoSuchTrainer'"):
        ttrainer.get_trainer("NoSuchTrainer")


class _Built(RuntimeError):
    pass


@pytest.mark.parametrize("over, error, match", [
    (dict(optimizer="RMSprop"), ValueError, "unknown optimizer 'RMSprop'"),
    (dict(dp_devices=2, batch_size=3), ValueError,
     "batch_size 3 not divisible by dp_devices 2"),
    (dict(multihost=True), RuntimeError,
     "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT"),
], ids=["optimizer", "dp_devices", "multihost"])
def test_config_errors_raise_before_the_model(over, error, match, tmp_path,
                                              monkeypatch):
    def built(*a, **k):
        raise _Built("a model was built")
    monkeypatch.setattr(ttrainer, "init_unet", built)
    # two ranks, as under torchrun; no torchrun environment
    monkeypatch.setattr(ttrainer.ddp, "world_size", lambda group=None: 2)
    for k in ttrainer.ddp.ENV:
        monkeypatch.delenv(k, raising=False)
    cfg = base_config(tconfig, str(tmp_path), **over)
    with pytest.raises(error, match=match):
        ttrainer.HardestContrastiveLossTrainer(cfg, None, None, device="cpu")
    cfg = base_config(tconfig, str(tmp_path), dp_devices=-1)
    with pytest.raises(_Built):
        ttrainer.HardestContrastiveLossTrainer(cfg, None, None, device="cpu")


def test_unported_dataset_raises(tmp_path):
    """A dataset name of neither registry (IndoorPairDataset is the 3DMatch
    reader's base class, not in JAX's dataset_str_mapping) raises before
    any reader is built."""
    cfg = base_config(tconfig, str(tmp_path), dataset="IndoorPairDataset")
    with pytest.raises(NotImplementedError, match="neither"):
        make_data_loader(cfg, "train", 2)


def test_labeler_of_another_architecture_raises(tmp_path):
    lab_dir = tmp_path / "labeler"
    lab_dir.mkdir()
    base_config(tconfig, str(lab_dir), model="SimpleNetBN").save(
        str(lab_dir / "config.json"))
    cfg = base_config(tconfig, str(tmp_path / "run"),
                      labeler_dir=str(lab_dir))
    with pytest.raises(ValueError, match="labeler architecture differs"):
        ttrainer.CorrespondenceExtensionTrainer(cfg, None, None,
                                                device="cpu")
