"""MViTv2-S 16x4 (``models/mvit.py``) against its plain reference
(``tests/plain_mvit.py``, plain torch, materialized attention, no code of
the port), in float32 on the CPU, at a small size that keeps every kind of
block: width 8, 4 blocks with transitions at 1 and 3, K/V stride 4, 4
frames of 32 px (a (2, 8, 8) token grid), 2 clips, 5 classes, drop path
on, on the reference's seeded random weights. Its blocks hold a Q grid
over a smaller K grid (8 over 2), equal grids at a transition (4 and 4),
and a Q grid under its K grid (2 under 4). Besides: the decomposed bias
against an explicit gather at the cell's grid pairs, AdamW against
``torch.optim.AdamW``, ``Conv3d`` with groups and bias, the published
geometry on the meta device, PySlowFast's init, the spans of an eager
profiled step, train_unimodal with a resume, the random-sized crops, and
validate_args's refusals.

Tolerances: the port and the reference take the same sums in another
order (the port's logits are one ``baddbmm`` that scales the product and
adds the bias; the reference scales q first and adds the bias after), so
float32 agrees to about 1e-6. The logits are held to 1e-5 of the largest,
every leaf's gradient and the parameters after one AdamW step to 1e-4 of
the larger of the leaf's largest entry and the median leaf's (float32
reads 2.5e-7, 1.5e-6 and 4.8e-6), in float64 to 1e-6 (the model
hands back float32 logits, so float32's round-off at that cast stays).
Computing in bfloat16 (8 bits of mantissa against float32's 24) misses the
logits' tolerance 1,400-fold (0.0146) and the gradients' 20,000-fold."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adamml_tpu_torch.cli import train_adamml, train_unimodal
from adamml_tpu_torch.configs.config import (arg_parser, config_from_args,
                                             validate_args)
from adamml_tpu_torch.data.aug_params import sample_crop_flip
from adamml_tpu_torch.models import model_builder
from adamml_tpu_torch.models import mvit as tmv
from adamml_tpu_torch.models.layers import Conv3d, Dense, LayerNorm
from adamml_tpu_torch.ops import attention
from adamml_tpu_torch.ops.dropout import drop_path
from adamml_tpu_torch.train.optim import AdamW, build_optimizer
from adamml_tpu_torch.train.steps import (make_unimodal_train_step,
                                          step_generators)
from adamml_tpu_torch.train.train_state import TrainState
from adamml_tpu_torch.utils.flops import count_model_flops

import plain_mvit as plain
from torch_parity import one_torch_thread  # noqa: F401

SMALL = dict(num_classes=5, embed_dim=8, depth=4, transitions=(1, 3),
             kv_stride=4, frames=4, input_size=32)
SPEC = plain.Spec(lr=1e-3, **SMALL)
N = 2
FULL = ["--backbone_net", "mvit", "--modality", "rgb", "--dataset",
        "kinetics400", "--groups", "16", "--frames_per_group", "4",
        "--num_segments", "1", "--dense_sampling", "--optimizer", "adamw"]


def _model(dtype=torch.float32):
    return tmv.MViT(dtype=dtype, **SMALL)


def _weights(seed=3, dtype=torch.float32):
    w = plain.make_weights(plain.param_specs(SPEC), seed, "cpu")
    return {k: v.to(dtype) for k, v in w.items()}


def _clips(seed=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, SPEC.frames, SPEC.input_size, SPEC.input_size, 3),
                    generator=g)
    return x, torch.randint(0, SPEC.num_classes, (N,), generator=g)


def _loaded(w, dtype=torch.float32):
    model = _model(dtype)
    model.load_state_dict(w, strict=True)
    return model.double() if dtype == torch.float64 else model


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _drop():
    return step_generators(torch.device("cpu"), 11, 0)[1]


def test_the_names_and_shapes_are_the_reference_s():
    got = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    assert got == {n: s for n, s, _ in plain.param_specs(SPEC)}


def test_the_small_model_holds_every_kind_of_block():
    grids = [(b.attn.q_grid[1], b.attn.kv_grid[1], b.proj is not None)
             for b in _model().blocks]
    assert grids == [(8, 2, False), (4, 4, True), (4, 2, False),
                     (2, 4, True)]
    assert grids == [(g.grid_q[1], g.grid_kv[1], g.dim_in != g.dim_out)
                     for g in plain.geometry(SPEC)]


def _logits(w, x, train, dtype=torch.float32):
    model = _loaded(w, dtype)
    with torch.no_grad():
        got = model(x.to(dtype), train=train, generator=_drop())
        want = plain.forward({k: v.to(w["cls_token"].dtype)
                              for k, v in w.items()}, SPEC,
                             x.to(w["cls_token"].dtype), train=train,
                             dropout=_drop())
    assert got.dtype == torch.float32 and got.shape == (N, 5)
    return _gap(got.to(want.dtype), want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_match_the_reference(train):
    x, _ = _clips()
    assert _logits(_weights(), x, train) < 1e-5
    assert _logits(_weights(dtype=torch.float64), x, train,
                   torch.float64) < 1e-6


def test_bfloat16_misses_the_logits_tolerance():
    x, _ = _clips()
    for train in (True, False):
        assert _logits(_weights(), x, train, torch.bfloat16) > 1e-3


def _one_step(w, dtype=torch.float32):
    """One AdamW step of the port (its unimodal train step, the clip at
    1.0) and of the reference from weights w: (port loss, reference loss,
    port gradients as the update takes them, reference's, port
    parameters after, reference's)."""
    x, target = _clips()
    model = _loaded(w, dtype)
    x = x.double() if dtype == torch.float64 else x
    opt = build_optimizer("main", dataclasses.replace(
        config_from_args(arg_parser().parse_args(FULL)).optim,
        lr=SPEC.lr, weight_decay=SPEC.weight_decay), model.parameters())
    metrics = make_unimodal_train_step(model, clip_gradient=SPEC.clip)(
        TrainState(opt, None), x, target, SPEC.lr, 11)
    grads = {n: opt.state[p]["exp_avg"] / (1 - plain.BETAS[0])
             for n, p in model.named_parameters()}
    trainer = plain.Trainer(SPEC, w, ckpt=False)
    loss, taken = trainer.step(x.to(w["cls_token"].dtype), target, _drop())
    return (float(metrics["loss"]), loss, grads, taken,
            dict(model.named_parameters()), trainer.params)


def _leaf_gaps(got, want, names=None):
    """Each leaf's largest gap over the larger of its largest entry and
    the median leaf's (as the benchmark's check: some leaves are all but
    zero)."""
    names = list(want if names is None else names)
    scale = {k: float(want[k].abs().max()) for k in names}
    med = float(np.median(list(scale.values())))
    return {k: float((got[k].detach().to(want[k].dtype) - want[k]).abs()
                     .max()) / max(scale[k], med) for k in names}


def _moved(taken):
    """The leaves whose change is compared: a key's LayerNorm bias shifts
    every logit of a row alike, which the softmax cancels, so its gradient
    is round-off and AdamW's first step moves it by +-lr at random."""
    return [k for k in taken if not k.endswith("norm_k.bias")]


def test_loss_every_gradient_and_the_adamw_update_match():
    loss, ref_loss, grads, taken, params, ref_params = _one_step(_weights())
    assert abs(loss - ref_loss) < 1e-5 * abs(ref_loss)
    g = _leaf_gaps(grads, taken)
    assert max(g.values()) < 1e-4, sorted(g.items(), key=lambda t: -t[1])[:3]
    # only the cls token leaves the last block, and its query is neither
    # convolved nor given relative positions: those leaves take no
    # gradient at all; a key's LayerNorm bias takes round-off
    scale = {k: float(t.abs().max()) for k, t in taken.items()}
    med = float(np.median(list(scale.values())))
    last = f"blocks.{SPEC.depth - 1}.attn."
    assert {k for k, v in scale.items() if v == 0} == {
        last + n for n in ("pool_q.weight", "rel_pos_h", "rel_pos_w",
                           "rel_pos_t")}
    assert {k for k, v in scale.items() if 0 < v < 1e-5 * med} == {
        k for k in scale if k.endswith("norm_k.bias")}
    u = _leaf_gaps(params, ref_params, _moved(taken))
    assert max(u.values()) < 1e-4


def test_every_leaf_matches_in_float64():
    loss, ref_loss, grads, taken, params, ref_params = _one_step(
        _weights(dtype=torch.float64), torch.float64)
    assert abs(loss - ref_loss) < 1e-6 * abs(ref_loss)
    assert max(_leaf_gaps(grads, taken).values()) < 1e-6
    assert max(_leaf_gaps(params, ref_params, _moved(taken)).values()) < 1e-6


def test_bfloat16_misses_the_gradient_tolerance():
    _, _, grads, taken, _, _ = _one_step(_weights(), torch.bfloat16)
    assert max(_leaf_gaps(grads, taken).values()) > 1e-2


# the distinct (Q, K) spatial grids of the cell's blocks: block 0, the
# transitions 1, 3 and 14, stages 2-4
CELL_GRIDS = [(56, 7), (28, 14), (28, 7), (14, 14), (14, 7), (7, 14),
              (7, 7)]


@pytest.mark.parametrize("qs,ks", CELL_GRIDS,
                         ids=[f"{q}_{k}" for q, k in CELL_GRIDS])
def test_rel_pos_bias_is_the_explicit_gather(qs, ks):
    """The decomposed bias of every query and key pair against
    q . (Rt[dt] + Rh[dh] + Rw[dw]) gathered pair by pair (2 frames, head
    dim 4), and the index rule at the pair's grids."""
    t, d = 2, 4
    g = torch.Generator().manual_seed(qs * 100 + ks)
    sp = 2 * max(qs, ks) - 1
    tables = (torch.randn(2 * t - 1, d, generator=g),
              torch.randn(sp, d, generator=g),
              torch.randn(sp, d, generator=g))
    dists = (attention.rel_dist(t, t), attention.rel_dist(qs, ks),
             attention.rel_dist(qs, ks))
    q = torch.randn(1, 1, t * qs * qs, d, generator=g, dtype=torch.float64)
    got = attention.rel_pos_bias(q, [x.double() for x in tables], dists,
                                 (t, qs, qs), (t, ks, ks))[0, 0]
    qi = torch.arange(t * qs * qs)
    ki = torch.arange(t * ks * ks)
    qt, qh, qw = qi // (qs * qs), qi // qs % qs, qi % qs
    kt, kh, kw = ki // (ks * ks), ki // ks % ks, ki % ks
    rows = (tables[0].double()[dists[0][qt[:, None], kt[None, :]]]
            + tables[1].double()[dists[1][qh[:, None], kh[None, :]]]
            + tables[2].double()[dists[2][qw[:, None], kw[None, :]]])
    want = (q[0, 0][:, None, :] * rows).sum(-1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-12
    # each index in the table, one offset a table row, equal offsets on
    # the finer grid's scale sharing it
    dh = dists[1]
    assert int(dh.min()) == 0 and int(dh.max()) <= sp - 1
    fine = max(qs, ks)
    scaled = (torch.arange(qs)[:, None] * (fine // qs)
              - torch.arange(ks)[None, :] * (fine // ks))
    assert torch.equal(dh - dh[0, 0], scaled - scaled[0, 0])
    assert torch.equal(dh, plain.rel_dist(qs, ks))


@pytest.mark.parametrize("foreach", [True, False])
def test_adamw_matches_torch_adamw(foreach):
    """Three steps over a matrix, a vector and a 3-D tensor, the 1-D
    parameter in a group without decay, against torch's AdamW."""
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 4), (4,), (1, 1, 6)]
    start = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes] for _ in range(3)]
    cfg = config_from_args(arg_parser().parse_args(FULL)).optim
    cfg = dataclasses.replace(cfg, lr=1e-2, weight_decay=0.05,
                              fused_update=foreach)
    ours = [torch.nn.Parameter(p.clone()) for p in start]
    theirs = [torch.nn.Parameter(p.clone()) for p in start]
    opt = build_optimizer("main", cfg, ours)
    assert isinstance(opt, AdamW)
    assert [len(gr["params"]) for gr in opt.param_groups] == [2, 1]
    ref = torch.optim.AdamW(
        [{"params": [theirs[0], theirs[2]]},
         {"params": [theirs[1]], "weight_decay": 0.0}],
        lr=1e-2, weight_decay=0.05, foreach=False)
    for step in grads:
        for o, p, gr in ((opt, ours, step), (ref, theirs, step)):
            for t, gi in zip(p, gr):
                t.grad = gi.clone()
            o.step()
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max()) < 1e-6
    # the 1-D parameter took no decay: zero gradients leave it unmoved
    sd = opt.state_dict()
    assert sd["param_groups"][1]["weight_decay"] == 0.0
    assert all(sd["param_groups"][i]["decoupled_weight_decay"]
               for i in (0, 1))


def test_sgd_stays_the_default_optimizer():
    cfg = config_from_args(arg_parser().parse_args(
        ["--backbone_net", "mvit"]))
    assert cfg.optim.optimizer == "sgd"
    opt = build_optimizer("main", cfg.optim, [torch.nn.Parameter(
        torch.zeros(3))])
    assert type(opt).__name__ == "SGD"


@pytest.mark.parametrize("kernel,strides,groups,bias", [
    ((3, 3, 3), (1, 2, 2), 8, False),
    ((3, 7, 7), (2, 4, 4), 1, True),
    ((1, 3, 3), (1, 2, 2), 4, True),
    ((1, 1, 1), 1, 1, False),
], ids=["depthwise", "patch", "folded_groups", "slowfast_pointwise"])
def test_conv3d_groups_and_bias_match_f_conv3d(kernel, strides, groups,
                                               bias):
    """Channels first (``ncdhw``, MViT's pooling) for every case; channels
    last (``forward``, SlowFast's and the patch embedding's) ungrouped,
    and a grouped convolution refused there."""
    g = torch.Generator().manual_seed(1)
    conv = Conv3d(8, 8, kernel, strides, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        if bias:
            conv.bias.copy_(torch.randn(8, generator=g))
    x = torch.randn(2, 4, 9, 9, 8, generator=g)
    st = strides if isinstance(strides, tuple) else (strides,) * 3
    want = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias, st,
                    tuple(k // 2 for k in kernel), groups=groups)
    if groups == 1:
        got = conv(x)
        assert float((got.permute(0, 4, 1, 2, 3) - want).abs().max()) < 1e-5
    else:
        with pytest.raises(ValueError, match="ncdhw"):
            conv(x)
    # channels first, as MViT's pooling calls it
    first = conv.ncdhw(x.permute(0, 4, 1, 2, 3).contiguous())
    assert float((first - want).abs().max()) < 1e-5
    # SlowFast's calls name neither: one weight, no bias
    assert set(conv.state_dict()) == ({"weight", "bias"} if bias
                                      else {"weight"})


def test_published_geometry_and_parameters():
    """At the published widths (meta device): 34.5 M parameters as the
    paper's table, the widths, heads, grids and table sizes of each
    block."""
    with torch.device("meta"):
        model = tmv.MViT()
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6
               - 34.5) < 0.1
    rows = [(b.attn.dim_out, b.attn.heads, b.attn.q_grid, b.attn.kv_grid,
             tuple(b.attn.rel_pos_h.shape), b.proj is not None)
            for b in model.blocks]
    q56, q28, q14, q7 = ((8, s, s) for s in (56, 28, 14, 7))
    assert rows[0] == (96, 1, q56, q7, (111, 96), False)
    assert rows[1] == (192, 2, q28, q14, (55, 96), True)
    assert rows[2] == (192, 2, q28, q7, (55, 96), False)
    assert rows[3] == (384, 4, q14, q14, (27, 96), True)
    assert all(r == (384, 4, q14, q7, (27, 96), False) for r in rows[4:14])
    assert rows[14] == (768, 8, q7, q14, (27, 96), True)
    assert rows[15] == (768, 8, q7, q7, (13, 96), False)
    assert all(tuple(b.attn.rel_pos_t.shape) == (15, 96)
               for b in model.blocks)
    assert [b.drop for b in model.blocks] == pytest.approx(
        np.linspace(0, 0.2, 16), abs=1e-7)
    assert tuple(model.head.weight.shape) == (400, 768)
    spec = plain.Spec()
    assert {n: s for n, s, _ in plain.param_specs(spec)} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_init_model_follows_pyslowfast():
    cfg = config_from_args(arg_parser().parse_args(FULL))
    model, arch = model_builder.build_model(cfg, "cpu")
    assert "mvitv2-s" in arch and cfg.model.num_classes == 400
    dense = torch.cat([m.weight.detach().flatten() for m in model.modules()
                       if isinstance(m, Dense)])
    assert abs(float(dense.std()) / 0.02 - 1) < 0.01
    assert float(dense.abs().max()) <= 2.0
    for m in model.modules():
        if isinstance(m, Dense):
            assert torch.all(m.bias == 0)
        elif isinstance(m, LayerNorm):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
            assert m.eps == 1e-6
        elif isinstance(m, Conv3d):
            # torch's default: uniform within 1 / sqrt(fan_in)
            bound = 1 / math.sqrt(math.prod(m.weight.shape[1:]))
            assert float(m.weight.abs().max()) <= bound
            assert float(m.weight.abs().max()) > 0.9 * bound
    tables = torch.cat([t.detach().flatten() for n, t in
                        model.named_parameters() if "rel_pos" in n])
    assert abs(float(tables.std()) / 0.02 - 1) < 0.05
    assert abs(float(model.cls_token.std()) / 0.02 - 1) < 0.3


def test_drop_path_keeps_or_drops_whole_clips():
    x = torch.ones(64, 3, 5)
    out = drop_path(x, 0.25, True, torch.Generator().manual_seed(2))
    rows = out.reshape(64, -1)
    kept = rows[:, 0] != 0
    assert torch.all(rows[kept] == 1 / 0.75) and torch.all(rows[~kept] == 0)
    assert 0 < int(kept.sum()) < 64
    assert drop_path(x, 0.0, True, None) is x
    assert drop_path(x, 0.25, False, None) is x


def test_random_sized_crops_are_the_loader_s():
    """The reference's crops and flips against the loader's
    ``sample_crop_flip(version="random_sized")``, draw for draw, on the
    cell's 256 x 340 canvases and on small and portrait pictures that
    take the fallback."""
    hw = np.array([[256, 340]] * 40 + [[180, 300], [300, 120], [20, 500]])
    want = sample_crop_flip(hw, input_size=224, train=True,
                            version="random_sized",
                            rng=np.random.RandomState(7))
    got = plain.random_sized_crops(hw, np.random.RandomState(7), 224)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_spans_bracket_forward_and_backward_of_an_eager_step(tmp_path):
    """In a profiled eager train step the ``model.pool``, ``model.attn``
    and ``model.mlp`` ranges open once a block in the forward and once in
    the backward, never overlap on one thread, and hold the pooling
    convolutions, the attention's matmuls and the MLP's."""
    import json

    model = _loaded(_weights())
    x, target = _clips()
    opt = AdamW(model.parameters(), lr=1e-3)
    step = make_unimodal_train_step(model, clip_gradient=1.0)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        step(TrainState(opt, None), x, target, 1e-3, 3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    names = ("model.pool", "model.attn", "model.mlp")
    spans = [e for e in events if e.get("name") in names]
    assert {n: sum(e["name"] == n for e in spans) for n in names} == {
        n: 2 * SPEC.depth for n in names}
    wins = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["tid"], e["name"]) for e in spans)
    for (a0, a1, ta, _), (b0, b1, tb, _) in zip(wins, wins[1:]):
        assert ta != tb or a1 <= b0

    def inside(op):
        out = set()
        for e in events:
            if e.get("name") == op:
                ts = float(e["ts"])
                out |= {w[3] for w in wins
                        if w[2] == e["tid"] and w[0] <= ts <= w[1]}
        return out

    assert inside("aten::convolution_backward") == {"model.pool"}
    assert inside("aten::baddbmm") == {"model.attn"}
    assert inside("aten::gelu_backward") == {"model.mlp"}


def test_spans_cost_nothing_unprofiled(monkeypatch):
    """With no profiler and no capture the spans make no autograd node."""
    x, _ = _clips()

    def count(out):
        seen, stack = set(), [out.grad_fn]
        while stack:
            n = stack.pop()
            if n is None or n in seen:
                continue
            seen.add(n)
            stack.extend(m for m, _ in n.next_functions)
        return len(seen)

    with_spans = count(_loaded(_weights())(x))
    monkeypatch.setattr(tmv, "spanned", lambda name, fn, x, *a: fn(x, *a))
    assert count(_loaded(_weights())(x)) == with_spans


def test_attention_and_linear_layers_are_counted():
    """``count_model_flops`` (``--show_model``) counts the qkv, projection
    and MLP GEMMs, the convolutions, both attention GEMMs and the
    relative-position einsums: at the small size, against a count by
    hand."""
    model = _model()
    x, _ = _clips()
    got = count_model_flops(model, x[:1], train=False)
    t, s = 2, 8
    want = 2 * 8 * 3 * 3 * 7 * 7 * t * s * s            # patch embedding
    for g in plain.geometry(SPEC):
        lin, lq, lk = (1 + math.prod(g.grid_in), 1 + math.prod(g.grid_q),
                       1 + math.prod(g.grid_kv))
        d = g.dim_out // g.heads
        want += 2 * lin * g.dim_in * 3 * g.dim_out               # qkv
        want += 2 * 27 * g.heads * d * (lq - 1 + 2 * (lk - 1))   # pools
        want += 2 * g.heads * lq * lk * d * 2                    # qk, av
        want += 2 * g.heads * (lq - 1) * d * sum(g.grid_kv)      # rel
        want += 2 * lq * g.dim_out * g.dim_out                   # proj
        want += 2 * lq * g.dim_out * 8 * g.dim_out               # mlp
        if g.dim_in != g.dim_out:
            want += 2 * lin * g.dim_in * g.dim_out               # skip
    want += 2 * 32 * 5                                           # head
    assert got == want


@pytest.fixture
def small_mvit(monkeypatch):
    """build_model's MViT at width 8 and 4 blocks (16 frames of 224 px,
    the sizes validate_args holds it to)."""
    monkeypatch.setattr(model_builder, "MViT", functools.partial(
        tmv.MViT, embed_dim=8, depth=4, transitions=(1, 3)))


def test_train_unimodal_trains_evaluates_and_resumes(tmp_path, small_mvit):
    argv = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "mvit", "--groups", "16", "--frames_per_group", "1",
            "--num_segments", "1", "--dense_sampling", "-b", "2",
            "--epochs", "1", "--synthetic_length", "2", "--val_num_clips",
            "1", "--compute_dtype", "float32", "-j", "2", "--optimizer",
            "adamw", "--wd", "0.05", "--lr", "1e-3", "--clip_gradient",
            "1.0", "--augmentor_ver", "random_sized", "--lr_scheduler",
            "cosine", "--logdir", str(tmp_path)]
    assert train_unimodal.main(argv, device="cpu") == 0
    folder = next(p for p in tmp_path.iterdir() if p.is_dir())
    assert "mvitv2-s" in folder.name
    saved = torch.load(folder / "checkpoint" / "state.pt",
                       weights_only=False)["main_opt"]
    assert len(saved["param_groups"]) == 2
    assert {"step", "exp_avg", "exp_avg_sq"} <= set(
        next(iter(saved["state"].values())))
    assert train_unimodal.main(
        argv[:argv.index("--epochs") + 1] + ["2"]
        + argv[argv.index("--epochs") + 2:]
        + ["--resume", str(folder / "checkpoint")], device="cpu") == 0
    second = next(p for p in tmp_path.iterdir() if p.name.endswith("-e2"))
    lines = (second / "log.log").read_text().splitlines()
    assert any("loaded checkpoint" in line and "(epoch 1)" in line
               for line in lines)
    assert [line.split(":")[0] for line in lines
            if line.startswith(("Train:", "Val:"))] == ["Train", "Val"]


def test_show_model_counts_mvit(capsys, small_mvit):
    argv = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "mvit", "--groups", "16", "--show_model"]
    assert train_unimodal.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Total params" in out and "GFLOPs" in out
    assert "unavailable" not in out


@pytest.mark.parametrize("change,flag", [
    (["--modality", "flow"], "--modality"),
    (["--num_segments", "2"], "--num_segments"),
    (["--groups", "8"], "--groups"),
    (["--input_size", "256"], "--input_size"),
    (["-d", "101"], "--depth"),
], ids=["modality", "segments", "frames", "size", "depth"])
def test_validate_args_refuses_what_mvit_cannot_take(change, flag):
    parser = arg_parser()
    args = parser.parse_args(FULL + change)
    with pytest.raises(ValueError, match=flag):
        validate_args(parser, args)


def test_train_adamml_refuses_adamw(tmp_path):
    with pytest.raises(ValueError, match="--optimizer adamw"):
        train_adamml.main(["--optimizer", "adamw", "--logdir",
                           str(tmp_path)], device="cpu")
