"""PyTorch port, the CLI surface, against the JAX package: the argument
parser (flag for flag), ``config_from_args`` and ``arch_name`` on the verify
commands' argv, the flags the port rejects (each by name), the schedulers,
meters, metrics and modeled FLOPs, and ``parse_hostfile`` (that the port
imports no JAX: tests/test_torch_adamml.py).

Everything here is host arithmetic: equal means equal (``==``), except the
float LR grid and mAP, which must agree to the last bit as well
(``assert_array_equal``).
"""

import dataclasses
import platform
import time

import numpy as np
import pytest
import torch

from adamml_tpu.cli import train_adamml as jcli
from adamml_tpu.configs import config as jconfig
from adamml_tpu.train import schedulers as jsched
from adamml_tpu.utils import flops as jflops
from adamml_tpu.utils import meters as jmeters
from adamml_tpu.utils import metrics as jmetrics
from adamml_tpu_torch.cli import train_adamml as tcli
from adamml_tpu_torch.cli import train_unimodal as tuni
from adamml_tpu_torch.configs import config as tconfig
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.train import schedulers as tsched
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.utils import flops as tflops
from adamml_tpu_torch.utils import meters as tmeters
from adamml_tpu_torch.utils import metrics as tmetrics

from torch_parity import one_torch_thread  # noqa: F401

# the two documented synthetic verify commands (logdir dropped)
VERIFY_UNIMODAL = (
    "--dataset synthetic --modality rgb --backbone_net resnet -d 18 "
    "--groups 4 -b 8 --epochs 2 --input_size 32 --synthetic_length 8 -j 2 "
    "--lr_scheduler multisteps --lr_steps 1").split()
VERIFY_ADAMML = (
    "--dataset synthetic --modality rgb sound --groups 4 --num_segments 2 "
    "--dense_sampling --val_num_clips 2 -b 8 --epochs 1 --warmup_epochs 1 "
    "--finetune_epochs 1 --input_size 32 --audio_length 0.16 "
    "--synthetic_length 8 --causality_modeling lstm --cost_weights 1.0 0.05 "
    "-j 2 --lr_scheduler multisteps --lr_steps 1").split()
# tests/test_e2e.py::TestFlagValidation's argv: rejected by both packages
BAD_ARGV = [["--threed_data"], ["--pred_weights", "0.5"], ["--after_softmax"],
            ["--pred_files", "a.npy", "b.npy", "--pred_weights", "0.5"],
            ["--num_segments", "2"]]


def _actions(parser):
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, a.nargs, a.choices, a.const, a.type,
        type(a).__name__) for a in parser._actions}


# the port's own choices beyond the JAX package's: its 3D models and the
# dataset they train on
PORT_CHOICES = {("--backbone_net",): ["slowfast", "mvit"],
                ("--dataset",): ["kinetics400"]}
# the port's own flags, with the config fields they set: train_unimodal's
# optimizer (SGD by default, as the JAX package trains)
PORT_FLAGS = {("--optimizer",): ("optim", "optimizer")}


def _jax_fields(cfg) -> dict:
    """The config as a dict without the port's own fields."""
    d = dataclasses.asdict(cfg)
    for part, field in PORT_FLAGS.values():
        d[part].pop(field)
    return d


def test_arg_parser_has_the_jax_flag_set():
    """Every flag: its spellings, destination, default, nargs, choices,
    const, type and action kind; the port's choices are the JAX package's
    and ``PORT_CHOICES``, its flags the JAX package's and ``PORT_FLAGS``
    (``--optimizer`` defaulting to sgd)."""
    want = _actions(jconfig.arg_parser())
    for flag, extra in PORT_CHOICES.items():
        dest, default, nargs, choices, const, typ, kind = want[flag]
        want[flag] = (dest, default, nargs, list(choices) + extra, const,
                      typ, kind)
    got = _actions(tconfig.arg_parser())
    assert got.pop(("--optimizer",)) == ("optimizer", "sgd", None,
                                         ["sgd", "adamw"], None, None,
                                         "_StoreAction")
    assert got == want


@pytest.mark.parametrize("argv", [VERIFY_UNIMODAL, VERIFY_ADAMML] + BAD_ARGV,
                         ids=["verify_unimodal", "verify_adamml", "threed",
                              "weights", "softmax", "files", "segments"])
def test_config_from_args_matches(argv):
    """The same dataclasses, field for field, and the same arch name."""
    tcfg = tconfig.config_from_args(tconfig.arg_parser().parse_args(argv))
    jcfg = jconfig.config_from_args(jconfig.arg_parser().parse_args(argv))
    assert _jax_fields(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.optim.optimizer == "sgd"
    for test_mode in (False, True):
        assert (tconfig.arch_name(tcfg, test_mode)
                == jconfig.arch_name(jcfg, test_mode))


def test_dataclass_fields_and_modality_constants_match():
    tcfg, jcfg = tconfig.ExperimentConfig(), jconfig.ExperimentConfig()
    assert _jax_fields(tcfg) == dataclasses.asdict(jcfg)
    for m in tconfig.MODALITIES:
        assert tconfig.modality_mean(m) == jconfig.modality_mean(m)
        assert tconfig.modality_std(m) == jconfig.modality_std(m)


@pytest.mark.parametrize("argv", BAD_ARGV,
                         ids=["threed", "weights", "softmax", "files",
                              "segments"])
def test_validate_args_rejects_the_same_argv(argv):
    for cfgmod in (jconfig, tconfig):
        parser = cfgmod.arg_parser()
        with pytest.raises(SystemExit):
            cfgmod.validate_args(parser, parser.parse_args(argv))


# (argv, the flag the ValueError must name, and what else it says):
# README.md's flag table
REJECTED = [
    (["--mesh_data", "2"], "--mesh_data", "world size"),
    (["--mesh_model", "2"], "--mesh_model", "world size"),
    (["--world-size", "2", "--mesh_data", "4"], "--mesh_data", "world size"),
    (["--gpu", "0,1"], "--gpu", "--multiprocessing-distributed"),
    (["--world-size", "2", "--mesh_model", "3"], "--mesh_model",
     "world size"),
    (["--mesh_data", "2", "--mesh_model", "2", "--world-size=2"],
     "--mesh_data", "world size over --mesh_model"),
]


@pytest.mark.parametrize("argv,flag,why", REJECTED,
                         ids=[f"{f}-{a[-1]}" for a, f, _ in REJECTED])
def test_rejected_flags_name_themselves(argv, flag, why):
    """--mesh_data other than -1 or the world size over --mesh_model,
    --mesh_model that does not divide the world size (2 at world size 1,
    3 at 2) and two devices without --multiprocessing-distributed."""
    parser = tconfig.arg_parser()
    args = parser.parse_args(["--dataset", "synthetic"] + argv)
    with pytest.raises(ValueError, match=flag) as err:
        tconfig.validate_args(parser, args)
    assert why in str(err.value)


# flags whose modules are ported since: accepted, and reaching the config
PORTED = [
    (["--pretrained", "/x"], lambda c: c.runtime.pretrained == "/x"),
    (["--unimodality_pretrained", "/x", "/y"],
     lambda c: c.runtime.unimodality_pretrained == ["/x", "/y"]),
    (["--dataset", "kinetics-sounds", "--datadir", "/r", "/s"],
     lambda c: c.data.dataset == "kinetics-sounds"
     and c.data.datadir == ["/r", "/s"]),
    (["--steps_per_dispatch", "2"], lambda c: c.optim.steps_per_dispatch == 2),
    (["--eval_capacity", "0.5"], lambda c: c.model.eval_capacity == 0.5),
    (["--capacity_groups", "2"], lambda c: c.model.capacity_groups == 2),
    (["--profile_dir", "/x"], lambda c: c.runtime.profile_dir == "/x"),
    (["--pred_files", "a.npy"], lambda c: c.runtime.pred_files == ["a.npy"]),
    (["--multiprocessing-distributed"],
     lambda c: c.runtime.multiprocessing_distributed),
    (["--gpu", "0,1", "--multiprocessing-distributed", "--mesh_data", "2"],
     lambda c: c.runtime.mesh_data == 2),
    (["--dist-url", "tcp://127.0.0.1:1", "--world-size", "2", "--rank", "1",
      "--mesh_data", "2", "--sync-bn"],
     lambda c: (c.runtime.dist_url, c.runtime.world_size, c.runtime.rank,
                c.runtime.sync_bn) == ("tcp://127.0.0.1:1", 2, 1, True)),
    (["--hostfile", "/h", "--mesh_data", "3"],
     lambda c: c.runtime.hostfile == "/h" and c.runtime.mesh_data == 3),
    (["--mesh_model", "2", "--world-size", "2"],
     lambda c: (c.runtime.mesh_model, c.runtime.world_size) == (2, 2)),
]


@pytest.mark.parametrize("argv,holds", PORTED,
                         ids=[a[0] for a, _ in PORTED])
def test_ported_flags_are_accepted(argv, holds):
    assert holds(_accepted(argv)[1])


def _accepted(argv):
    parser = tconfig.arg_parser()
    args = parser.parse_args(["--dataset", "synthetic"] + argv)
    tconfig.validate_args(parser, args)
    return args, tconfig.config_from_args(args)


def test_accepted_flags_and_their_meaning(capsys):
    """--compute_dtype, --use_pallas_dw, --no_fused_tpool and --sync-bn
    reach the model config; --mesh_data -1 and 1 and --mesh_model 1 are one
    card; --no_fused_update is foreach=False; --gpu/--gpu_id pick the card
    (each rank its own under --multiprocessing-distributed);
    --disable_cudnn_benchmark warns and --dist-backend does not (it picks
    the process group's backend)."""
    _, cfg = _accepted(["--compute_dtype", "float32", "--use_pallas_dw",
                        "--no_fused_tpool", "--sync-bn", "--mesh_data", "1",
                        "--mesh_model", "1", "--steps_per_dispatch", "1"])
    assert cfg.model.compute_dtype == "float32" and cfg.model.use_pallas_dw
    assert not cfg.model.fused_tpool and cfg.runtime.sync_bn
    _, cfg = _accepted(["--no_fused_update"])
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert build_optimizer("main", cfg.optim, p).defaults["foreach"] is False
    assert build_optimizer("policy", cfg.optim, p).defaults["foreach"] is False
    _, cfg = _accepted([])
    assert build_optimizer("main", cfg.optim, p).defaults["foreach"] is True
    args, _ = _accepted(["--gpu", "3"])
    assert tconfig.cuda_device(args) == "cuda:3"
    args, _ = _accepted(["--gpu_id", "1"])
    assert tconfig.cuda_device(args) == "cuda:1"
    assert tconfig.cuda_device(_accepted([])[0]) == "cuda"
    args, _ = _accepted(["--gpu", "2,5", "--multiprocessing-distributed"])
    assert [tconfig.cuda_device(args, i) for i in (0, 1)] == ["cuda:2",
                                                              "cuda:5"]
    assert tconfig.run_devices(args, "cpu") == ["cpu", "cpu"]
    _accepted(["--disable_cudnn_benchmark", "--dist-backend", "nccl"])
    out = capsys.readouterr().out
    assert out.count("has no effect in the port") == 1
    assert "--dist-backend" not in out


@pytest.mark.parametrize("main", [tcli.main, tuni.main],
                         ids=["train_adamml", "train_unimodal"])
def test_main_without_device_needs_cuda(main, tmp_path):
    """On a machine without a card, main() raises before any work, unless
    device="cpu" is passed (tests/test_torch_cli.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset", "synthetic", "--modality", "rgb",
              "--logdir", str(tmp_path)])


@pytest.mark.parametrize("flag", ["--pretrained", "--unimodality_pretrained"])
def test_train_unimodal_refuses_pretrained_flags(flag, tmp_path):
    """Both graft into the AdaMML model: train_unimodal refuses them before
    any work."""
    with pytest.raises(ValueError, match="train_adamml takes them"):
        tuni.main(["--dataset", "synthetic", "--modality", "rgb", flag,
                   str(tmp_path), "--logdir", str(tmp_path)], device="cpu")


def test_distributed_runs_are_rejected(tmp_path):
    """Without a coordinator a multi-process run reaches init_distributed
    and fails there, for the coordinator alone: a world size of 2 with
    neither --dist-url nor --hostfile at once; a hostfile naming this host
    as rank 1 under a master (localhost:10598) that never answers, within
    the timeout. One process joins no group."""
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.world_size = 2
    with pytest.raises(ValueError, match="--world-size 2 .*coordinator"):
        tcli.init_distributed(cfg)
    hosts = tmp_path / "hosts.txt"
    hosts.write_text(f"localhost\n{platform.node()}\n")
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.hostfile = str(hosts)
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        tcli.init_distributed(cfg, timeout_s=2.0)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()
    assert tcli.init_distributed(flagship_cfg(tiny=True)).backend is None


@pytest.mark.parametrize("lines,node", [
    (["node1 slots=8\n", "node10 slots=8\n"], "node10.cluster.local"),
    (["node1\n", "node10\n"], "node1"),
    (["\n", "a.x.y\n", "b\n", "c\n"], "c"),
])
def test_parse_hostfile_matches(lines, node):
    assert tcli.parse_hostfile(lines, node) == jcli.parse_hostfile(lines,
                                                                   node)


@pytest.mark.parametrize("lines,node", [([], "a"), (["a\n", "b\n"], "c"),
                                        (["a\n", "a\n"], "a")])
def test_parse_hostfile_errors_match(lines, node):
    for cli in (jcli, tcli):
        with pytest.raises(RuntimeError):
            cli.parse_hostfile(lines, node)


# --------------------------------------------------------------------------
# schedulers, meters, metrics, modeled FLOPs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler,steps", [
    ("step", [15]), ("step", [2.0]), ("multisteps", [15, 30, 45]),
    ("multisteps", [1]), ("multisteps", [45, 3.5, 20]), ("cosine", [15]),
])
def test_lr_at_epoch_matches(scheduler, steps):
    for total in (1, 7, 50):
        grid = range(0, total + 3)
        got = [tsched.lr_at_epoch(scheduler, 0.01, e, steps, total)
               for e in grid]
        want = [jsched.lr_at_epoch(scheduler, 0.01, e, steps, total)
                for e in grid]
        np.testing.assert_array_equal(got, want)
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.lr_at_epoch("plateau", 0.01, 0, steps, 10)


def test_reduce_lr_on_plateau_trajectory_and_state_dict():
    """The same LR trajectory over a loss curve that improves, stalls past
    the patience and improves again; a state_dict round trip mid-way
    continues it."""
    rs = np.random.RandomState(0)
    losses = list(2.0 - np.arange(5) * 0.1) + [1.7] * 25 + list(
        1.0 + rs.rand(10) * 0.01)
    t, j = tsched.ReduceLROnPlateau(0.1), jsched.ReduceLROnPlateau(0.1)
    traj_t, traj_j = [], []
    for i, v in enumerate(losses):
        if i == 20:
            state = t.state_dict()
            assert state == j.state_dict()
            t = tsched.ReduceLROnPlateau(0.5)
            t.load_state_dict(state)
        traj_t.append(t.step(v))
        traj_j.append(j.step(v))
    assert traj_t == traj_j
    assert min(traj_t) < 0.1 * 0.1 + 1e-12  # decayed twice


def test_meters_match():
    t, j = tmeters.AverageMeter(), jmeters.AverageMeter()
    for val, n in ((1.0, 2), (4.0, 1), (2.5, 7)):
        t.update(val, n)
        j.update(val, n)
        assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count,
                                                  j.avg)


@pytest.mark.parametrize("classes", [5, 31])
def test_metrics_match(classes):
    rs = np.random.RandomState(classes)
    logits = rs.randn(40, classes).astype(np.float32)
    logits[3] = logits[4]  # a tie between rows changes no ranking rule
    labels = rs.randint(0, classes, 40)
    multi = (rs.rand(40, classes) > 0.6).astype(np.float32)
    for topk in ((1, 5), (1, 2, 3)):
        assert (tmetrics.accuracy(logits, labels, topk)
                == jmetrics.accuracy(logits, labels, topk))
    for target in (labels, multi):
        assert (tmetrics.actnet_acc(logits, target)
                == jmetrics.actnet_acc(logits, target))
    assert (tmetrics.mean_average_precision(logits, multi)
            == jmetrics.mean_average_precision(logits, multi))


@pytest.mark.parametrize("modality", [["rgb", "sound"], ["rgb", "flow"],
                                      ["rgb", "flow", "sound"], ["sound"]])
@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "flagship"])
def test_flops_computation_matches(modality, tiny):
    segments = flagship_cfg(tiny=tiny).model.num_segments
    rs = np.random.RandomState(len(modality))
    ratios = {m: float(rs.rand()) for m in modality}
    assert (tflops.flops_computation(modality, ratios, segments)
            == jflops.flops_computation(modality, ratios, segments))
    assert tflops.MAIN_FLOPS == jflops.MAIN_FLOPS
    assert tflops.POLICY_FLOPS == jflops.POLICY_FLOPS
