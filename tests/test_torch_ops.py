"""PyTorch port: configs, small ops, losses and metrics against the JAX
package, on the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from adamml_tpu.configs import config as jcfg
from adamml_tpu.models import adamml as jadamml
from adamml_tpu.models import mobilenet_v2 as jmnv2
from adamml_tpu.ops import augment as jaug
from adamml_tpu.ops import gumbel as jgumbel
from adamml_tpu.ops import spectrogram as jspec
from adamml_tpu.ops import temporal as jtemporal
from adamml_tpu.train import losses as jlosses
from adamml_tpu.train import steps as jsteps
from adamml_tpu_torch.configs import config as tcfg
from adamml_tpu_torch.models import adamml as tadamml
from adamml_tpu_torch.models import mobilenet_v2 as tmnv2
from adamml_tpu_torch.ops import augment as taug
from adamml_tpu_torch.ops import gumbel as tgumbel
from adamml_tpu_torch.ops import spectrogram as tspec
from adamml_tpu_torch.ops import temporal as ttemporal
from adamml_tpu_torch.train import losses as tlosses
from adamml_tpu_torch.train import steps as tsteps

from torch_parity import one_torch_thread, t  # noqa: F401


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_cfg_matches(tiny):
    ours, theirs = tcfg.flagship_cfg(tiny), graft._flagship_cfg(tiny)
    got = dataclasses.asdict(ours)
    # the port's own field: train_unimodal's optimizer, SGD as the JAX
    # package trains
    assert got["optim"].pop("optimizer") == "sgd"
    assert got == dataclasses.asdict(theirs)
    for test_mode in (False, True):
        assert (tcfg.arch_name(ours, test_mode)
                == jcfg.arch_name(theirs, test_mode))


def test_arch_name_variants_match():
    for edit in (dict(rng_policy=True), dict(fusion_point="fc2"),
                 dict(backbone_net="resnet"),
                 dict(backbone_net="sound_mobilenet_v2"),
                 dict(without_t_stride=True, causality_modeling=None)):
        ours, theirs = tcfg.ExperimentConfig(), jcfg.ExperimentConfig()
        for k, v in edit.items():
            setattr(ours.model, k, v)
            setattr(theirs.model, k, v)
        assert tcfg.arch_name(ours) == jcfg.arch_name(theirs)
    assert (tcfg.ModelConfig(modality=["rgbdiff", "flow"]).major_modality
            == ["flow"])


def test_constants_and_datasets_match():
    from adamml_tpu.configs import dataset_config as jds
    from adamml_tpu_torch.configs import dataset_config as tds

    for name in ("MODALITIES", "NUM_CONSECUTIVE_FRAMES", "IMAGENET_MEAN",
                 "IMAGENET_STD", "FLOW_MEAN", "FLOW_STD"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for m in jcfg.MODALITIES:
        assert tcfg.input_channels_for(m) == jcfg.input_channels_for(m)
    # the port adds Kinetics-400, its 3D model's dataset
    assert set(tds.DATASET_CONFIG) == set(jds.DATASET_CONFIG) | {
        "kinetics400"}
    k400 = tds.get_dataset_config("kinetics400")
    assert (k400.num_classes, k400.train_list_name, k400.val_list_name,
            k400.image_tmpl) == (400, "train.txt", "val.txt", "{:05d}.jpg")
    for name in jds.DATASET_CONFIG:
        assert (dataclasses.asdict(tds.get_dataset_config(name))
                == dataclasses.asdict(jds.get_dataset_config(name)))
    with pytest.raises(KeyError, match="unknown dataset"):
        tds.get_dataset_config("no-such-set")


@pytest.mark.parametrize("audio_length", [1.28, 0.16, 0.5])
def test_spectrogram_shapes_match(audio_length):
    ours = tspec.SpectrogramConfig(audio_length=audio_length)
    theirs = jspec.SpectrogramConfig(audio_length=audio_length)
    for attr in ("num_samples", "win_length", "hop_length", "num_freqs",
                 "num_frames"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("f", [1, 2, 3, 4, 5, 8])
def test_temporal_pool_matches(mode, f):
    """k3 s2 pad1 over frames; avg counts padded frames (count_include_pad).
    Exact for max, 1e-6 for avg (float32 sum order)."""
    x = np.random.RandomState(f).randn(2, f, 3, 3, 4).astype(np.float32)
    got = ttemporal.temporal_pool(t(x), 3, 2, mode).numpy()
    want = np.asarray(jtemporal.temporal_pool(jnp.asarray(x), 3, 2, mode))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert ttemporal.out_frames(f) == want.shape[1]


@pytest.mark.parametrize("f", [2, 3, 4, 5])
def test_temporal_pool_tie_gradient_routes_to_first_max(f):
    """Ties within a window send the whole gradient to the first maximum,
    as lax.reduce_window's VJP does (amax split it evenly: [1, 3, 3] gave
    [0, 0.5, 0.5] where JAX gives [0, 1, 0])."""
    rs = np.random.RandomState(f)
    x = np.repeat(rs.randn(2, 1, 3), f, axis=1).astype(np.float32)
    x[0, 0] -= 1.0  # one strict maximum beside the ties
    ct = rs.randn(2, ttemporal.out_frames(f), 3).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jtemporal.temporal_pool(v, 3, 2, "max"),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = t(x).requires_grad_(True)
    ttemporal.temporal_pool(tx, 3, 2, "max").backward(t(ct))
    np.testing.assert_array_equal(tx.grad.numpy(), want)


def test_relu6_gradient_is_zero_at_the_bounds():
    """The MobileNetV2 activation's gradient is 0 at exactly 0 and 6 and 1
    between, as jax.nn.relu6's (torch.clamp's is 1 at both bounds)."""
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jax.nn.relu6(v).sum())(
        jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0, 0, 1, 0, 0])
    class Identity(torch.nn.Module):
        def forward(self, v, *args):
            return v

    layer = tmnv2._ConvBNReLU6(1, 1, kernel=1)
    layer.bn = Identity()  # the activation sees the conv output exactly
    with torch.no_grad():
        layer.conv.weight.fill_(1.0)
    tx = t(x).reshape(5, 1, 1, 1).requires_grad_(True)
    layer(tx, train=False).sum().backward()
    np.testing.assert_array_equal(tx.grad.flatten().numpy(), want)


def test_dropout_follows_its_generator():
    """Keep mask from the caller's generator only: the same seed gives the
    same mask whatever the global generator holds; kept entries scale by
    1/(1-p), as flax's nn.Dropout; off outside train mode and at p = 0."""
    from adamml_tpu_torch.ops.dropout import dropout

    x = torch.ones(4000)
    runs = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        runs.append(dropout(x, 0.25, True,
                            torch.Generator().manual_seed(7)))
    assert torch.equal(runs[0], runs[1])
    assert set(runs[0].unique().tolist()) == {
        0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs(float((runs[0] == 0).float().mean()) - 0.25) < 0.03
    assert not torch.equal(runs[0], dropout(
        x, 0.25, True, torch.Generator().manual_seed(8)))
    assert dropout(x, 0.25, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)


def test_gumbel_matches_with_same_noise():
    """The port's hard sample with JAX's own Gumbel noise gives JAX's
    decision. The port's forward value is the exact one-hot; JAX's
    y_hard + y_soft - y_soft may sit one float32 ulp (< 1.2e-7) off it."""
    key = jax.random.PRNGKey(5)
    logits = np.random.RandomState(0).randn(3, 7, 2).astype(np.float32)
    for tau in (5.0, 0.7):
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        want = np.asarray(jgumbel.gumbel_decision(key, jnp.asarray(logits),
                                                  tau))
        sample = tgumbel.perturbed_hard_sample(t(logits), t(noise), tau)
        assert set(sample.unique().tolist()) <= {0.0, 1.0}
        np.testing.assert_allclose(sample[..., -1].numpy(), want, rtol=0,
                                   atol=1.2e-7)
        want_full = np.asarray(jgumbel.gumbel_softmax_hard(
            key, jnp.asarray(logits), tau))
        np.testing.assert_allclose(sample.numpy(), want_full, rtol=0,
                                   atol=1.2e-7)


def test_gumbel_decision_draws_from_generator():
    logits = torch.zeros(4000, 2)
    d1 = tgumbel.gumbel_decision(torch.Generator().manual_seed(1), logits, 1.)
    d2 = tgumbel.gumbel_decision(torch.Generator().manual_seed(1), logits, 1.)
    assert torch.equal(d1, d2)
    assert set(d1.unique().tolist()) == {0.0, 1.0}
    assert abs(d1.mean().item() - 0.5) < 0.05  # zero logits: fair coin


@pytest.mark.parametrize("hw,size,tol", [(224, 160, 5e-5), (32, 24, 1e-6)])
def test_policy_stream_matches(hw, size, tol):
    """Bilinear with antialias (jax.image.resize's linear minification),
    frame stride 2. Tolerance: float32 filter-weight rounding."""
    x = np.random.RandomState(hw).randn(1, 2, 3, hw, hw, 3).astype(np.float32)
    got = taug.policy_stream(t(x), size=size, stride=2).numpy()
    want = np.asarray(jaug.policy_stream(jnp.asarray(x), size=size, stride=2))
    assert got.shape == want.shape == (1, 2, 2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=tol)


def test_cross_entropy_and_topk_match():
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 9).astype(np.float32)
    labels = rs.randint(0, 9, 6)
    multi = (rs.rand(6, 9) > 0.6).astype(np.float32)
    for tgt in (labels, multi):
        np.testing.assert_allclose(
            tlosses.cross_entropy(t(logits), t(tgt)).item(),
            float(jlosses.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(tgt))), rtol=1e-6)
        # all-equal logits: lax.top_k ranks ties by class index
        for lg in (logits, np.zeros_like(logits)):
            ours = tsteps._topk_metrics(t(lg), t(tgt))
            theirs = jsteps._topk_metrics(jnp.asarray(lg), jnp.asarray(tgt))
            for k in ("top1", "top5"):
                np.testing.assert_allclose(float(ours[k]), float(theirs[k]))


def test_channel_rules_match():
    for v in (3, 8.5, 16, 31.9, 1280 * 1.4, 95.0):
        assert tmnv2.make_divisible(v) == jmnv2.make_divisible(v)
    for mod in (["rgb", "sound"], ["rgbdiff", "flow"], ["flow", "rgbdiff",
                                                        "sound"]):
        assert (tadamml.split_modalities(mod)
                == jadamml.split_modalities(mod))


def test_profile_tool_helpers():
    from adamml_tpu_torch.tools import profile_eval_step as prof

    assert prof._union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    for name, cls in (
            ("void (anonymous namespace)::tpool_fused_kernel<__nv_bfloat16>",
             "fused_epilogue"),
            ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32", "convolution"),
            ("void at::native::(anonymous namespace)::conv_depthwise2d_"
             "forward_kernel<3, c10::BFloat16, int>(GenericPackedTensor"
             "Accessor<index_t>)", "convolution"),
            ("void at::native::vectorized_elementwise_kernel<8, at::native::"
             "bfloat16_copy_kernel_cuda>", "elementwise"),
            ("void at::native::reduce_kernel<512, 1>", "reduction"),
            ("nvjet_tst_64x512_64x2_1x2_h_ssched_bz_coopB_TNT", "matmul"),
            ("some_unknown_kernel", "other")):
        assert prof.kernel_class(name) == cls, name
