"""The port's Trainer, checkpoints, gradient accumulation and the two
training CLIs, against the JAX package where the result is seed-free.

``torch.Generator`` cannot reproduce ``jax.random`` and no JAX Trainer runs
here (``tests/test_torch_port_train.py`` pins the step itself), so the loop
is held to what does not depend on the draws: the metric keys the JAX loop
logs, ``train/lr`` against the optax schedule, the checkpoint steps that
the JAX manager keeps for the same saves, and the resume path rules.
Bars: gradient accumulation against ``optax.MultiSteps`` >= 40 dB on the
updates; checkpoint round trips and the resumed state bitwise; validation's
images bitwise a fresh pipeline's on the state's masters.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_util import cut_config, snr_db
from mvd_tpu.checkpoint import CheckpointManager as JCheckpointManager
from mvd_tpu.checkpoint import resolve_resume_path as j_resolve_resume_path
from mvd_tpu.config import OptimizerConfig as JOptimizerConfig
from mvd_tpu.train import TrainState as JTrainState
from mvd_tpu.train import make_optimizer as j_make_optimizer
from mvd_tpu.train.state import make_lr_schedule as j_make_lr_schedule
from mvd_tpu_torch.checkpoint import CheckpointManager, load_params, resolve_resume_path, save_params
from mvd_tpu_torch.checkpoint.io import FORMAT
from mvd_tpu_torch.config import TINY_MODEL, OptimizerConfig, TrainConfig
from mvd_tpu_torch.data.objaverse import ObjaverseDataModule
from mvd_tpu_torch.pipeline import MVDPipeline
from mvd_tpu_torch.pipeline.pipeline import build_model
from mvd_tpu_torch.train import TrainState
from mvd_tpu_torch.train.loop import Trainer
from tests.test_data import make_zip

UPDATE_BAR_DB = 40.0
IMG = 32
MODEL = dataclasses.replace(
    cut_config(TINY_MODEL), dtype="bfloat16",
    unet=dataclasses.replace(cut_config(TINY_MODEL).unet, sample_size=IMG // 8))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 objects of 3 views at 48² (resized to 32²): 8 train, 1 val, 1 test."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "renders_final").mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        make_zip(root / "renders_final" / f"obj_{i}.zip", num_views=3, size=48, rng=rng)
    return str(root)


class _Toy(torch.nn.Module):
    """Two trainable leaves under the camera-encoder marker, one frozen."""

    def __init__(self):
        super().__init__()
        self.camera_encoder = torch.nn.Linear(3, 2)
        self.unet = torch.nn.Linear(2, 2, bias=False)


def _toy_state(k=1, lr=0.1, total=10):
    torch.manual_seed(0)
    cfg = TrainConfig(model=TINY_MODEL, grad_accum_steps=k,
                      optimizer=OptimizerConfig(learning_rate=lr, weight_decay=0.3))
    return TrainState.create(torch.nn.ModuleDict({"mvd": _Toy()}), cfg, total)


def _toy_step(state, rng):
    for p in state.trainable.values():
        p.grad = torch.from_numpy((3 * rng.normal(size=tuple(p.shape))).astype(np.float32))
    norm = torch.sqrt(sum(p.grad.square().sum() for p in state.trainable.values()))
    state.apply_gradients(norm)


def _snapshot(state):
    """Everything a checkpoint holds, copied."""
    opt = {k: {n: (v.clone() if torch.is_tensor(v) else v) for n, v in s.items()}
           for k, s in state.optimizer.state_dict()["state"].items()}
    return dict(params={k: v.clone() for k, v in state.model["mvd"].state_dict().items()},
                opt=opt, step=state.step, updates=state.updates, mini_step=state.mini_step,
                acc=None if state.acc is None else {k: v.clone() for k, v in state.acc.items()})


def _assert_bitwise(a, b):
    assert a["step"] == b["step"] and a["updates"] == b["updates"]
    assert a["mini_step"] == b["mini_step"]
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert a["params"][k].dtype == b["params"][k].dtype and torch.equal(a["params"][k], b["params"][k]), k
    assert a["opt"].keys() == b["opt"].keys()
    for k in a["opt"]:
        for n in a["opt"][k]:
            assert torch.equal(torch.as_tensor(a["opt"][k][n]), torch.as_tensor(b["opt"][k][n])), (k, n)
    assert (a["acc"] is None) == (b["acc"] is None)
    for k in a["acc"] or {}:
        assert torch.equal(a["acc"][k], b["acc"][k])


# ------------------------------------------------------ gradient accumulation


@pytest.mark.parametrize("k", [1, 2])
def test_grad_accumulation_matches_optax_multisteps(k):
    """k calls per update: the mean gradient, clipped by its own norm, one
    AdamW step every k-th call at the schedule's count of real updates
    (optax.MultiSteps inside the trainable branch); step counts calls."""
    state = _toy_state(k=k, total=4)
    toy = state.model["mvd"]
    jparams = {"params": {"camera_encoder": {"kernel": toy.camera_encoder.weight.detach().numpy().T.copy(),
                                              "bias": toy.camera_encoder.bias.detach().numpy().copy()}}}
    tx = j_make_optimizer(JOptimizerConfig(learning_rate=0.1, weight_decay=0.3), jparams, total_steps=4,
                          train_denoising_unet=True, grad_accum_steps=k)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, jparams), tx)
    japply = jax.jit(lambda s, g: s.apply_gradients(g))
    rng = np.random.default_rng(1)
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    for call in range(4 * k):
        gk = (3 * rng.normal(size=(3, 2))).astype(np.float32)
        gb = (3 * rng.normal(size=2)).astype(np.float32)
        jstate = japply(jstate, {"params": {"camera_encoder": {"kernel": jnp.asarray(gk),
                                                               "bias": jnp.asarray(gb)}}})
        toy.camera_encoder.weight.grad = torch.from_numpy(gk.T.copy())
        toy.camera_encoder.bias.grad = torch.from_numpy(gb)
        state.apply_gradients(torch.sqrt(torch.tensor(float((gk**2).sum() + (gb**2).sum()))))
        assert state.step == call + 1 and state.updates == (call + 1) // k
        jp = jstate.params["params"]["camera_encoder"]
        want = np.concatenate([np.asarray(jp["kernel"]).T.ravel(), np.asarray(jp["bias"])])
        got = np.concatenate([toy.camera_encoder.weight.detach().numpy().ravel(),
                              toy.camera_encoder.bias.detach().numpy()])
        start = np.concatenate([before["camera_encoder.weight"].numpy().ravel(),
                                before["camera_encoder.bias"].numpy()])
        if call + 1 < 2 * k:  # no update yet, or the first at lr 0
            assert np.array_equal(got, start) and np.array_equal(want, start)
        else:
            assert snr_db(want - start, got - start) >= UPDATE_BAR_DB, call


# -------------------------------------------------------------- checkpoints


def test_checkpoint_retention_keeps_topk_plus_last(tmp_path):
    """tests/test_checkpoint.py:175's sequence: the top 3 by loss plus the
    latest, whose stale metric ranks 4th."""
    state = _toy_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3, save_interval_steps=1)
    seq = {1: 0.08288, 2: 0.07204, 3: 0.06692, 4: 0.06165,
           5: 0.06356, 6: 0.06077, 7: 0.05813, 8: 0.06222}
    for s, loss in seq.items():
        state.step = s
        assert mgr.save(s, state, metrics={"val/noise_loss": loss}, force=True)
    assert mgr.all_steps() == [4, 6, 7, 8]
    assert mgr.latest_step() == 8 and mgr.best_step() == 7
    # a save without the metric never takes a top-k slot, only the latest
    for s in (9, 10):
        assert mgr.save(s, state)  # on the interval
    assert mgr.all_steps() == [4, 6, 7, 10]
    mgr2 = CheckpointManager(str(tmp_path / "ckpt2"), save_interval_steps=5)
    assert not mgr2.save(3, state) and mgr2.save(3, state, force=True) and mgr2.save(5, state)


@pytest.mark.parametrize("k", [1, 2])
def test_checkpoint_round_trip_is_bitwise(tmp_path, k):
    """Parameters (f32 masters and the frozen ones in the compute dtype),
    AdamW state, counts and the accumulator restore bitwise into a fresh
    state; a save of an existing step replaces it; a half-written save is
    not a step; the meta names the format."""
    rng = np.random.default_rng(0)
    state = _toy_state(k=k)
    state.model["mvd"].unet.weight.data = state.model["mvd"].unet.weight.data.to(torch.bfloat16)
    for _ in range(3):
        _toy_step(state, rng)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    assert mgr.save(3, state, dataset_state={"train": {"seed": 1}}, extra={"wandb_run_id": "r1"},
                    metrics={"val/noise_loss": 0.5})
    want = _snapshot(state)
    os.makedirs(tmp_path / "ckpt" / ".tmp-4-1")  # a killed save
    fresh = _toy_state(k=k)
    fresh.model["mvd"].unet.weight.data = fresh.model["mvd"].unet.weight.data.to(torch.bfloat16)
    restored, meta = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert restored is fresh and mgr.latest_step() == 3
    _assert_bitwise(_snapshot(fresh), want)
    assert meta["format"] == FORMAT and meta["dataset_state"] == {"train": {"seed": 1}}
    assert meta["wandb_run_id"] == "r1" and meta["metrics"] == {"val/noise_loss": 0.5}
    # the restored state steps on exactly as the saved one
    _toy_step(state, np.random.default_rng(9))
    _toy_step(fresh, np.random.default_rng(9))
    _assert_bitwise(_snapshot(fresh), _snapshot(state))
    assert mgr.save(3, state)  # replaces step 3
    again = _toy_state(k=k)
    again.model["mvd"].unet.weight.data = again.model["mvd"].unet.weight.data.to(torch.bfloat16)
    mgr.restore(again, 3)
    _assert_bitwise(_snapshot(again), _snapshot(state))
    with open(tmp_path / "ckpt" / "3" / "meta.json", "w") as f:
        json.dump({"format": "orbax"}, f)
    with pytest.raises(ValueError, match="format"):
        mgr.restore(again, 3)


def test_save_and_load_params(tmp_path):
    sd = {"vae": {"w": torch.arange(4.0)}, "mvd": {"b": torch.ones(2, dtype=torch.bfloat16)}}
    save_params(str(tmp_path / "p"), sd, config_json="{}")
    got = load_params(str(tmp_path / "p"))
    assert torch.equal(got["vae"]["w"], sd["vae"]["w"]) and got["mvd"]["b"].dtype == torch.bfloat16


def test_resolve_resume_path_matches_jax(tmp_path):
    """tests/test_end_to_end.py:130 and :156: a run dir, its checkpoints/
    dir, a step dir and a bare dir of step dirs resolve; others raise."""
    run = tmp_path / "run"
    (run / "checkpoints" / "42").mkdir(parents=True)
    bare = tmp_path / "ckpt"
    (bare / "100").mkdir(parents=True)
    for p in (run, run / "checkpoints", run / "checkpoints" / "42", bare):
        assert resolve_resume_path(str(p)) == j_resolve_resume_path(str(p))
    (tmp_path / "outputs").mkdir()
    for p in (tmp_path / "outputs", tmp_path / "no_such_run"):
        with pytest.raises(FileNotFoundError):
            resolve_resume_path(str(p))
        with pytest.raises(FileNotFoundError):
            j_resolve_resume_path(str(p))


# ------------------------------------------------------------------ Trainer


def _train_cfg(max_steps):
    return TrainConfig(model=MODEL, optimizer=OptimizerConfig(learning_rate=1e-3), batch_size=2,
                       image_size=IMG, max_epochs=1, max_steps=max_steps, checkpoint_every_steps=2,
                       metrics_log_interval=2)


def _datamodule(corpus, pipe):
    return ObjaverseDataModule(corpus, pipe.tokenizer, image_size=IMG, batch_size=2, num_workers=2)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_fit_validate_and_resume(corpus, tmp_path, monkeypatch):
    saves = []
    real_save = CheckpointManager.save

    def recorded(self, step, state, **kw):
        ok = real_save(self, step, state, **kw)
        saves.append((step, kw.get("metrics"), kw.get("force", False), ok))
        return ok

    monkeypatch.setattr(CheckpointManager, "save", recorded)

    generated = []
    real_call = MVDPipeline.__call__

    def spy(self, *args, **kwargs):
        out = real_call(self, *args, **kwargs)
        generated.append((args, kwargs, out["images"].clone()))
        return out

    monkeypatch.setattr(MVDPipeline, "__call__", spy)

    cfg = _train_cfg(3)
    pipe = MVDPipeline.create(MODEL, seed=0, device="cpu")
    tr = Trainer(cfg, pipe, _datamodule(corpus, pipe), output_dir=str(tmp_path / "run"))
    tr.validate(0)  # at step 0
    state = tr.fit()  # validates at step 3, with the same seed
    assert state.step == 3 and [t["step"] for t in tr.timings] == [1, 2, 3]
    # trap: validation generates with this step's weights (the pipeline's
    # cached bf16 copy would keep those of the first validation), equal to
    # a fresh pipeline's on the state's masters
    (_, _, before), (args, kwargs, after) = generated
    assert not torch.equal(before, after)
    fresh_model = build_model(MODEL)
    fresh_model.load_state_dict(pipe.model.state_dict())
    fresh = MVDPipeline(MODEL, fresh_model, "cpu", pipe.tokenizer)
    assert torch.equal(fresh(*args, **kwargs)["images"], after)
    assert pipe._compute_model is None  # no copy held between validations

    recs = _records(tr.logger.jsonl_path)
    step_keys = {k for r in recs if r["step"] == 1 for k in r if k.startswith("train/")}
    # the keys of the JAX loop (train/loop.py): step metrics under train/,
    # the loop's own, the reconstruction tower and the validation pass
    loop_keys = {"train/step_time_s", "train/lr", "epoch"}
    recon = {"train/latent_recon_loss", "train/pixel_recon_loss", "train/ssim_value", "train/ssim_loss"}
    val = {"val/noise_loss", "val/gen_pixel_mse", "val/gen_psnr", "val/gen_ssim"}
    step_metrics = {k for k in step_keys if k not in loop_keys}
    assert {"train/noise_loss", "train/grad_norm/total", "train/mean_snr"} <= step_metrics
    groups = {"camera_encoder", "image_attention_processor", "down_modulators", "up_modulators",
              "mid_modulators"}
    assert {f"train/grad_norm/{g}" for g in groups} | {f"train/grad_max/{g}" for g in groups} <= step_metrics
    for r in recs:
        keys = set(r) - {"step", "time"}
        assert keys in ({"params/trainable", "params/total"}, step_metrics | loop_keys | {"epoch"},
                        recon, val, {f"grad/{g}" for g in groups}), keys
        for k in keys & (recon | val | {"train/noise_loss"}):
            assert np.isfinite(r[k]), k
    assert [r["step"] for r in recs if recon <= set(r)] == [2]
    assert [r["step"] for r in recs if val <= set(r)] == [0, 3]
    assert -1.0 <= [r for r in recs if val <= set(r)][0]["val/gen_ssim"] <= 1.0
    lr = j_make_lr_schedule(JOptimizerConfig(learning_rate=1e-3), 3)
    assert [r["train/lr"] for r in recs if "train/lr" in r] == pytest.approx(
        [float(lr(s)) for s in (1, 2, 3)], rel=1e-6)
    assert sorted(os.listdir(tr.dirs["comparisons"])) == ["epoch000_sample0.png", "epoch000_sample1.png"]
    assert tr.ckpt.all_steps() == [3]
    final = _snapshot(tr.state)

    # resume through the run dir, into a pipeline of other weights
    cfg5 = _train_cfg(5)
    pipe2 = MVDPipeline.create(MODEL, seed=1, device="cpu")
    tr2 = Trainer(cfg5, pipe2, _datamodule(corpus, pipe2), resume_from=tr.dirs["root"])
    assert tr2.dirs["root"] == tr.dirs["root"]
    assert tr2.resume()
    _assert_bitwise(_snapshot(tr2.state), final)
    tr2.fit()
    assert tr2.state.step == 5 and [t["step"] for t in tr2.timings] == [4, 5]
    recs = _records(tr2.logger.jsonl_path)
    lr5 = j_make_lr_schedule(JOptimizerConfig(learning_rate=1e-3), 5)
    assert [r["train/lr"] for r in recs if "train/lr" in r][3:] == pytest.approx(
        [float(lr5(s)) for s in (4, 5)], rel=1e-6)

    # the JAX manager keeps the same steps for the same saves
    jmgr = JCheckpointManager(str(tmp_path / "jax_ckpt"), max_to_keep=cfg.max_checkpoints,
                              save_interval_steps=cfg.checkpoint_every_steps)
    jstate = JTrainState.create({"params": {"w": jnp.ones(2)}}, optax.adam(1e-3))
    for step, metrics, force, ok in saves:
        assert ok == bool(jmgr.save(step, jstate.replace(step=jnp.asarray(step)), metrics=metrics,
                                    force=force))
    jmgr.wait()
    assert [s for s, *_ in saves] == [2, 3, 4, 5]
    # the same, but for one difference: orbax's BestN ranks a save without
    # the metric last yet lets it fill a free top-k slot (step 4 here); the
    # port keeps such a save only while it is the latest
    with_metric = {s for s, m, *_ in saves if m}
    assert sorted(jmgr.all_steps()) == [3, 4, 5]
    assert tr2.ckpt.all_steps() == [s for s in sorted(jmgr.all_steps()) if s in with_metric or s == 5]
    jmgr.close()
    # a resumed run that is complete takes no step and saves nothing
    n = len(saves)
    tr3 = Trainer(cfg5, pipe2, _datamodule(corpus, pipe2), resume_from=tr.dirs["root"])
    tr3.fit()
    assert tr3.state.step == 5 and not tr3.timings and len(saves) == n


def test_trainer_refuses_a_mesh_and_an_empty_loader(corpus, tmp_path):
    """A view-sharded Trainer needs a model sharded over the view axis (a
    mesh itself now runs: ``test_torch_port_sharded.py``); an empty train
    loader raises."""
    from mvd_tpu_torch.mesh import make_mesh

    pipe = MVDPipeline.create(MODEL, seed=0, device="cpu")
    with pytest.raises(ValueError, match="view_axis"):
        Trainer(_train_cfg(1), pipe, _datamodule(corpus, pipe), mesh=make_mesh(), view_sharded=True,
                output_dir=str(tmp_path / "v"))
    dm = ObjaverseDataModule(corpus, pipe.tokenizer, image_size=IMG, batch_size=64)
    with pytest.raises(ValueError, match="empty"):
        Trainer(_train_cfg(1), pipe, dm, output_dir=str(tmp_path / "o"))


# --------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """8 objects at the TINY model's 64²: all in the train split."""
    root = tmp_path_factory.mktemp("small")
    (root / "renders_final").mkdir()
    rng = np.random.default_rng(1)
    for i in range(8):
        make_zip(root / "renders_final" / f"obj_{i}.zip", num_views=2, size=64, rng=rng)
    return str(root)


def test_train_and_precompute_clis_on_the_cpu(small_corpus, tmp_path):
    from mvd_tpu_torch.cli import precompute_latents, train

    common = ["--tiny", "--device", "cpu", "--dataset-path", small_corpus, "--batch-size", "2"]
    out = str(tmp_path / "out")
    tr = train.main(common + ["--output-dir", out, "--max-steps", "2", "--wandb-id", "run-abc"])
    assert tr.state.step == 2 and tr.ckpt.all_steps() == [2]
    assert tr.logger.jsonl_path == os.path.join(out, "logs", "metrics.jsonl")
    tr2 = train.main(common + ["--output-dir", out, "--max-steps", "3", "--resume",
                               os.path.join(tr.dirs["root"], "checkpoints")])
    assert tr2.state.step == 3 and tr2.dirs["root"] == tr.dirs["root"]
    assert tr2.logger.run_id == "run-abc"  # from the checkpoint meta

    cache = str(tmp_path / "cache")
    stats = precompute_latents.main(["--tiny", "--device", "cpu", "--dataset-path", small_corpus,
                                     "--image-size", "64", "--out", cache, "--batch-size", "4"])
    assert stats == {"zips": 8, "views": 16, "skipped": 0}
    tr3 = train.main(common + ["--output-dir", str(tmp_path / "out3"), "--max-steps", "1",
                               "--latent-cache-dir", cache])
    assert tr3.state.step == 1
    assert "source_moments" in next(iter(tr3.train_loader))
    with pytest.raises(SystemExit, match="compute_dtype"):
        train.main(["--device", "cpu", "--dataset-path", small_corpus, "--latent-cache-dir", cache])


@pytest.mark.parametrize("argv,error,match", [
    (["--tiny"], RuntimeError, "CUDA is not available"),  # no CPU fallback without --device cpu
    # views over a mesh of 2 in a single process
    (["--num-views", "2", "--mesh-view", "2", "--device", "cpu"], SystemExit, "needs as many"),
    (["--mesh-view", "2"], SystemExit, "must divide"),  # 1 view does not shard over 2
    (["--num-processes", "2"], ValueError, "coordinator"),  # nowhere to meet
    # two slices of one process: the data axis of 1 does not divide, as in JAX
    (["--num-slices", "2", "--device", "cpu"], ValueError, "divisible by num_slices"),
])
def test_train_cli_refusals(argv, error, match):
    from mvd_tpu_torch.cli import train

    if torch.cuda.is_available() and error is RuntimeError:
        argv, error, match = argv, ValueError, "--device cpu"  # --tiny is for the CPU only
    with pytest.raises(error, match=match):
        train.main(argv + ["--dataset-path", "unused"])
