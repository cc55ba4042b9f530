"""PyTorch port, both training CLIs end to end on the CPU
(``main(argv, device="cpu")``) at tests/test_e2e.py::tiny_cfg's settings
given as flags, held to the JAX package's documented and tested behaviour
(tests/test_e2e.py and the verify commands' artifact list) rather than by running
the JAX trainer again:

  * the stage banners in order and the artifacts the verify notes list;
  * each epoch's learning rate equal to adamml_tpu.train.schedulers'
    ``lr_at_epoch`` (warmup at the base LR);
  * the temperature 5.0 * 0.965 after the alternating epoch, and the
    pre-decay 5.0 back with the model_best reload;
  * fresh optimizers at each stage boundary;
  * resume and auto-resume restoring stage, epoch, best top-1, plateau
    state, trainer seed and the pre-decay temperature;
  * ``-e`` writing its two files; ``train_unimodal`` for rgb and sound.

``--seed 5``: with 8 validation videos and 31 classes a random model's
top-1 is often 0, and then no model_best is written (the reference's
strict ``top1 > best``); at seed 5 the alternating epoch scores 12.5 with
every margin above 0.1, so the model_best path runs.
"""

import shutil

import numpy as np
import pytest
import torch

from adamml_tpu.train.schedulers import lr_at_epoch as jax_lr_at_epoch
from adamml_tpu_torch.cli import train_adamml, train_unimodal
from adamml_tpu_torch.configs.config import arg_parser, config_from_args
from adamml_tpu_torch.train import curriculum as cur

from torch_parity import one_torch_thread  # noqa: F401

TINY = (
    "--dataset synthetic --modality rgb sound -d 18 --groups 4 "
    "--num_segments 2 --dense_sampling --val_num_clips 2 -b 8 --epochs 1 "
    "--warmup_epochs 1 --finetune_epochs 1 --input_size 32 "
    "--audio_length 0.16 --synthetic_length 8 --causality_modeling lstm "
    "--cost_weights 1.0 0.05 --compute_dtype float32 --scale_range 36 48 "
    "-j 2 --lr_scheduler multisteps --lr_steps 1 --seed 5").split()
BANNERS = ["Stage [Warming up]: Main network with 1 epochs",
           "Stage [Alternative training]: 1 epochs",
           "Stage [Alternative training]: Training Main net",
           "Stage [Alternative training]: Training Policy net",
           "Stage [Post finetuning]: Finetune the main network 1 epochs",
           "Loaded model_best (epoch 1) for finetune"]
ARTIFACTS = {"checkpoint", "checkpoint_warmup_01", "checkpoint_main_01",
             "checkpoint_finetune_01", "model_best",
             "all_selection_main_1.npz", "all_selection_finetune_1.npz",
             "log.log"}


class _Recorder:
    """Wraps the curriculum's train_epoch and validate and the trainer's
    optimizer resets while a CLI runs: what each epoch was given and what
    the state held when it started."""

    def __init__(self, monkeypatch):
        self.calls, self.resets = [], []
        train_epoch, validate = cur.train_epoch, cur.validate
        reset = cur.AdaMMLTrainer._reset_optimizers

        def rec_train(loader, pre, step, state, **kw):
            self.calls.append(dict(
                kind="train", lr=kw["lr"], p_lr=kw["p_lr"],
                cost=list(kw["cost_weights"]), temperature=state.temperature,
                main_state=len(state.main_opt.state),
                policy_state=len(state.policy_opt.state)))
            return train_epoch(loader, pre, step, state, **kw)

        def rec_val(loader, pre, step, state, **kw):
            out = validate(loader, pre, step, state, **kw)
            self.calls.append(dict(kind="val", top1=out["top1"],
                                   temperature=state.temperature))
            return out

        def rec_reset(trainer):
            old = (trainer.state.main_opt, trainer.state.policy_opt)
            reset(trainer)
            self.resets.append(dict(
                temperature=trainer.state.temperature,
                fresh=all(new is not o and not new.state for new, o in
                          zip((trainer.state.main_opt,
                               trainer.state.policy_opt), old)),
                same_params=[p for g in trainer.state.main_opt.param_groups
                             for p in g["params"]] == list(
                                 trainer.model.main_net.parameters())))

        monkeypatch.setattr(cur, "train_epoch", rec_train)
        monkeypatch.setattr(cur, "validate", rec_val)
        monkeypatch.setattr(cur.AdaMMLTrainer, "_reset_optimizers",
                            rec_reset)


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """One log directory for the module's runs, removed at the end (the
    tiny flagship's checkpoints are ~0.2 GB each)."""
    path = tmp_path_factory.mktemp("cli")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def curriculum(logdir):
    """The full 3-stage curriculum through train_adamml.main on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        assert train_adamml.main(TINY + ["--logdir", str(logdir)],
                                 device="cpu") == 0
    cfg = config_from_args(arg_parser().parse_args(TINY))
    folder = next(p for p in logdir.iterdir() if p.is_dir())
    return dict(rec=rec, cfg=cfg, folder=folder,
                log=(folder / "log.log").read_text().splitlines())


def test_stage_banners_in_order(curriculum):
    lines = curriculum["log"]
    at = [next(i for i, line in enumerate(lines) if line.startswith(b))
          for b in BANNERS]
    assert at == sorted(at)
    assert sum(line.startswith("Train:") for line in lines) == 4
    assert sum(line.startswith("Val:") for line in lines) == 2
    for line in lines:
        if line.startswith(("Train:", "Val:")):
            assert "Selection: rgb:" in line and " sound:" in line
            assert "Loss: nan" not in line
        if line.startswith("Val:"):
            assert "mAP:" in line and "flops:" in line


def test_artifacts(curriculum):
    folder = curriculum["folder"]
    assert folder.name == (
        "synthetic-rgb-sound-adamml-j_mobilenet_v2-lstm-joint_resnet-18_"
        "mobilenet_v2-logits-ts-max-f4-s1-multisteps-bs8-e1")
    assert ARTIFACTS <= {p.name for p in folder.iterdir()}
    sel = np.load(folder / "all_selection_main_1.npz")
    assert str(sel["modality"]) == "rgb_sound"
    assert sel["selections"].shape == (8, 2, 2)
    assert sel["selections"].dtype == bool


def test_learning_rate_per_epoch_is_the_jax_schedule(curriculum):
    """warmup at the base LR (lr_epoch 0), then the live schedule: with
    milestones [1] both epoch-0 passes and finetune's epoch 0 run at the
    base LR as the JAX trainer computes it."""
    o = curriculum["cfg"].optim
    trains = [c for c in curriculum["rec"].calls if c["kind"] == "train"]
    assert [c["cost"] for c in trains] == [[0.0, 0.0], [0.0, 0.0],
                                           [1.0, 0.05], [0.0, 0.0]]
    for c in trains:  # every pass is epoch 0 of its stage
        assert c["lr"] == jax_lr_at_epoch(o.lr_scheduler, o.lr, 0,
                                          o.lr_steps, o.epochs)
        assert c["p_lr"] == jax_lr_at_epoch(o.lr_scheduler, o.p_lr, 0,
                                            o.lr_steps, o.epochs)


def test_temperature_decays_and_reload_restores_it(curriculum):
    """Alternating ends at 5.0 * 0.965 (the second boundary's optimizer
    reset sees it); finetune starts from model_best's pre-decay 5.0."""
    resets = curriculum["rec"].resets
    assert len(resets) == 3  # the trainer's first optimizers, 2 boundaries
    assert resets[1]["temperature"] == 5.0
    assert resets[2]["temperature"] == pytest.approx(5.0 * 0.965, rel=1e-6)
    trains = [c for c in curriculum["rec"].calls if c["kind"] == "train"]
    assert [c["temperature"] for c in trains] == [5.0, 5.0, 5.0, 5.0]


def test_fresh_optimizers_at_each_boundary(curriculum):
    """New optimizer objects with empty state over the same parameters at
    both boundaries: the warmup and the alternating main pass start empty,
    the policy pass finds no Adam state; finetune starts from the state
    that model_best carried (the reload replaces the fresh one)."""
    resets = curriculum["rec"].resets
    assert all(r["fresh"] and r["same_params"] for r in resets)
    trains = [c for c in curriculum["rec"].calls if c["kind"] == "train"]
    assert [c["main_state"] > 0 for c in trains] == [False, False, True,
                                                     True]
    assert [c["policy_state"] > 0 for c in trains] == [False, False, False,
                                                       True]
    assert next(c["top1"] for c in curriculum["rec"].calls
                if c["kind"] == "val") > 0  # so model_best was written


def test_trainer_lr_follows_the_jax_schedule(tmp_path):
    """The LR the trainer gives each epoch, for every closed-form
    scheduler, on a 6-epoch grid with milestones inside it."""
    t = _trainer(tmp_path, ["--epochs", "6", "--lr_steps", "2", "4"])
    o = t.cfg.optim
    for sched in ("step", "multisteps", "cosine"):
        o.lr_scheduler = sched
        for epoch in range(6):
            for base in (o.lr, o.p_lr):
                assert t._lr(epoch, base, None) == jax_lr_at_epoch(
                    sched, base, epoch, o.lr_steps, o.epochs)


def _trainer(logdir, extra=()):
    cfg = config_from_args(arg_parser().parse_args(
        TINY + ["--logdir", str(logdir), *extra]))
    return cur.AdaMMLTrainer(cfg, device="cpu")


class _Quiet:
    def log(self, msg):
        pass


def test_resume_restores_stage_and_pre_decay_temperature(curriculum, logdir):
    """--resume of the alternating epoch's checkpoint: its stage, epoch,
    best top-1, seed and the temperature it was saved with (before the
    decay); --auto_resume takes the latest checkpoint (finetune's)."""
    main_ckpt = curriculum["folder"] / "checkpoint_main_01"
    t = _trainer(logdir, ["--resume", str(main_ckpt)])
    seed0 = t.seed
    t.maybe_resume(_Quiet())
    assert t.curr_stage == "alternative_training" and t.start_epoch == 1
    assert t.state.temperature == 5.0
    assert t.best_top1 == 12.5 and t.seed != seed0
    t2 = _trainer(logdir, ["--auto_resume"])
    t2.maybe_resume(_Quiet())
    assert t2.curr_stage == "finetune" and t2.start_epoch == 1
    assert t2.state.temperature == 5.0
    sd = torch.load(curriculum["folder"] / "checkpoint" / "state.pt",
                    weights_only=True)
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, sd["model"][k]), k


def test_auto_resume_run_continues_where_it_stopped(curriculum, logdir):
    """A second CLI run with --auto_resume finds the finished finetune
    stage and trains nothing more."""
    assert train_adamml.main(TINY + ["--logdir", str(logdir),
                                     "--auto_resume"], device="cpu") == 0
    lines = (curriculum["folder"] / "log.log").read_text().splitlines()
    assert any(line.startswith("Found the checkpoint") for line in lines)
    assert sum(line.startswith("Train:") for line in lines) == 4


def test_plateau_state_survives_resume(tmp_path):
    """tests/test_e2e.py::TestSchedulerCheckpointing on the port."""
    args = ["--lr_scheduler", "plateau"]
    t = _trainer(tmp_path, args)
    for _ in range(12):
        t.plateau.step(1.0)
        t.p_plateau.step(1.0)
    assert t.plateau.lr == pytest.approx(0.01 * 0.1)
    t.save(3, "alternative_training", "_main")
    t2 = _trainer(tmp_path, args + ["--auto_resume"])
    t2.maybe_resume(_Quiet())
    assert t2.plateau.lr == pytest.approx(0.01 * 0.1)
    assert t2.p_plateau.lr == pytest.approx(0.01 * 0.1)
    assert t2.seed == t.seed and t2.curr_stage == "alternative_training"
    shutil.rmtree(t.log_folder)


def test_evaluate_writes_its_files(tmp_path):
    assert train_adamml.main(TINY + ["--logdir", str(tmp_path), "-e"],
                             device="cpu") == 0
    folder = next(p for p in tmp_path.iterdir() if p.is_dir())
    names = {p.name for p in folder.iterdir()}
    assert {"all_selection.npz", "val_1crops_2clips_32_details_.npy",
            "evaluate_log.log"} <= names
    out = np.load(folder / "val_1crops_2clips_32_details_.npy")
    assert out.shape == (8, 31) and np.isfinite(out).all()
    assert np.load(folder / "all_selection.npz")["selections"].shape == (
        8, 2, 2)


@pytest.mark.parametrize("modality,backbone", [("rgb", "resnet"),
                                               ("sound",
                                                "sound_mobilenet_v2")])
def test_train_unimodal_runs(tmp_path, modality, backbone):
    argv = ["--dataset", "synthetic", "--modality", modality, "-d", "18",
            "--groups", "4", "-b", "8", "--epochs", "1", "--input_size",
            "32", "--audio_length", "0.16", "--synthetic_length", "8",
            "--compute_dtype", "float32", "-j", "2", "--lr_scheduler",
            "multisteps", "--lr_steps", "1", "--logdir", str(tmp_path)]
    assert train_unimodal.main(argv, device="cpu") == 0
    folder = next(p for p in tmp_path.iterdir() if p.is_dir())
    assert backbone.split("_")[0] in folder.name
    assert {"checkpoint", "checkpoint_01", "log.log"} <= {
        p.name for p in folder.iterdir()}
    lines = (folder / "log.log").read_text().splitlines()
    assert [line.split(":")[0] for line in lines
            if line.startswith(("Train:", "Val:"))] == ["Train", "Val"]
    shutil.rmtree(folder)
    with pytest.raises(ValueError, match="exactly one --modality"):
        train_unimodal.main(argv + ["--modality", "rgb", "sound"],
                            device="cpu")


# -- the recipe on real files: unimodal pretraining, the curriculum from the
# unimodal checkpoints, then -e --pretrained --------------------------------

def _recipe_flags(tree, *modalities):
    return ["--dataset", "kinetics-sounds", "--datadir",
            *[str(tree / m) for m in modalities], "--modality", *modalities]


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The paper's recipe through both CLIs on a generated JPEG/WAV tree
    (8 videos of 16 frames at 48x64, one without a WAV): train_unimodal
    for rgb and for sound, train_adamml --unimodality_pretrained with their
    checkpoints, then train_adamml -e --pretrained with the curriculum's
    model_best (its checkpoint when no validation beat top-1 0). The
    model right after each graft is kept."""
    from adamml_tpu_torch.tools.bench_pipeline import generate_tree

    root = tmp_path_factory.mktemp("recipe")
    tree = root / "tree"
    generate_tree(str(tree), videos=8, frames=16, size=(48, 64))
    tiny = ["-d", "18", "--groups", "4", "-b", "8", "--epochs", "1",
            "--input_size", "32", "--audio_length", "0.16",
            "--compute_dtype", "float32", "--scale_range", "36", "48",
            "-j", "2", "--lr_scheduler", "multisteps", "--lr_steps", "1"]
    uni = {}
    for m in ("rgb", "sound"):
        logdir = root / f"uni_{m}"
        assert train_unimodal.main(_recipe_flags(tree, m) + tiny + [
            "--logdir", str(logdir)], device="cpu") == 0
        uni[m] = next(p for p in logdir.iterdir() if p.is_dir())
    # TINY's curriculum on the tree instead of synthetic videos
    adamml = _recipe_flags(tree, "rgb", "sound") + (
        "-d 18 --groups 4 --num_segments 2 --dense_sampling "
        "--val_num_clips 2 -b 8 --epochs 1 --warmup_epochs 1 "
        "--finetune_epochs 1 --input_size 32 --audio_length 0.16 "
        "--causality_modeling lstm --cost_weights 1.0 0.05 "
        "--compute_dtype float32 --scale_range 36 48 -j 2 "
        "--lr_scheduler multisteps --lr_steps 1 --seed 5").split()
    grafts = {}

    def keep(name, load):
        def run(model, *args, **kwargs):
            out = load(model, *args, **kwargs)
            grafts[name] = {k: v.clone()
                            for k, v in model.state_dict().items()}
            return out
        return run

    logdir = root / "adamml"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cur, "load_unimodality_pretrained",
                   keep("unimodal", cur.load_unimodality_pretrained))
        mp.setattr(cur, "load_pretrained_adamml",
                   keep("pretrained", cur.load_pretrained_adamml))
        assert train_adamml.main(adamml + [
            "--logdir", str(logdir), "--unimodality_pretrained",
            str(uni["rgb"] / "checkpoint"),
            str(uni["sound"] / "checkpoint")], device="cpu") == 0
        folder = next(p for p in logdir.iterdir() if p.is_dir())
        best = folder / "model_best"
        source = best if best.exists() else folder / "checkpoint"
        assert train_adamml.main(adamml + [
            "--logdir", str(root / "eval"), "-e", "--pretrained",
            str(source)], device="cpu") == 0
    yield dict(tree=tree, uni=uni, folder=folder, source=source,
               grafts=grafts, eval=next((root / "eval").iterdir()))
    shutil.rmtree(root, ignore_errors=True)


def test_recipe_unimodal_runs_on_real_files(recipe):
    for m, folder in recipe["uni"].items():
        assert folder.name.startswith(f"kinetics-sounds-{m}-")
        assert {"checkpoint", "checkpoint_01", "log.log"} <= {
            p.name for p in folder.iterdir()}
        lines = (folder / "log.log").read_text().splitlines()
        assert [line.split(":")[0] for line in lines
                if line.startswith(("Train:", "Val:"))] == ["Train", "Val"]
        assert not any("Loss: nan" in line for line in lines)


def test_recipe_unimodal_graft_is_bit_equal(recipe):
    """Right after the graft every tensor of main_net.net_rgb and
    main_net.net_sound is the unimodal checkpoint's."""
    model = recipe["grafts"]["unimodal"]
    for m, folder in recipe["uni"].items():
        sd = torch.load(folder / "checkpoint" / "state.pt",
                        weights_only=True)["model"]
        assert len(sd) > 100
        for k, v in sd.items():
            assert torch.equal(model[f"main_net.net_{m}.{k}"], v), k


def test_recipe_curriculum_stages_and_artifacts(recipe):
    lines = (recipe["folder"] / "log.log").read_text().splitlines()
    at = [next(i for i, line in enumerate(lines) if line.startswith(b))
          for b in BANNERS[:5]]
    assert at == sorted(at)
    assert sum(line.startswith("Train:") for line in lines) == 4
    assert sum(line.startswith("Val:") for line in lines) == 2
    assert not any("Loss: nan" in line for line in lines)
    assert recipe["folder"].name.startswith("kinetics-sounds-rgb-sound-")
    want = ARTIFACTS - {"model_best"}
    assert want <= {p.name for p in recipe["folder"].iterdir()}


def test_recipe_evaluate_with_pretrained(recipe, capsys):
    """-e --pretrained: the model right after the graft is the
    checkpoint's, tensor for tensor, at its temperature; -e wrote its
    files over the 8 validation videos."""
    payload = torch.load(recipe["source"] / "state.pt", weights_only=True)
    model = recipe["grafts"]["pretrained"]
    assert model.keys() == payload["model"].keys()
    for k, v in payload["model"].items():
        assert torch.equal(model[k], v), k
    lines = (recipe["eval"] / "evaluate_log.log").read_text().splitlines()
    assert any(line.startswith("Val:") for line in lines)
    out = np.load(recipe["eval"] / "val_1crops_2clips_32_details_.npy")
    assert out.shape == (8, 31) and np.isfinite(out).all()
