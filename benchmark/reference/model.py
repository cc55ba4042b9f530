"""Plain AdaMML (Panda et al., ICCV 2021; IBM/AdaMML models/adamml.py,
policy_net.py, joint_resnet_mobilenetv2.py, resnet.py,
sound_mobilenet_v2.py): the forward, loss, backward and update of one
train step, and the eval forward, in float32.

Functional: parameters and BN statistics are dicts of tensors keyed by the
names of the program's state dict (the flax tree's names), so the weights
the benchmark makes load into both sides under one name. Activations are
NCHW, frames folded into the batch clip-major: rows are (clip, segment,
frame).

- Train-mode BN takes its moments per segment over (clips, frames, H, W)
  (global moments when the rows do not split so), the variance as
  E[x^2] - E[x]^2 as flax computes it, biased for the normalize,
  unbiased for the running statistics, which fold the S segments' moments
  in order with momentum 0.9: ra <- m^S ra + sum_i (1-m) m^(S-1-i) x_i.
- ResNet-50 TSN: torchvision's v1.5 bottleneck (stride on the 3x3), a
  temporal max-pool (kernel 3, stride 2, padding 1) over frames after
  stages 1-3, global average pool, dropout, fc, mean over frames.
- MobileNetV2 (width 1): the audio backbone over 1x256x256 spectrograms
  and the policy trunks, which max-pool over frames before the first block
  of the 64- and 160-channel stages.
- Policy: trunk features -> concat -> two ReLU Dense(2048) -> LSTMCell
  (2048 + 2M -> 256, previous segment's logits appended) -> Dense(256 -> 2)
  per modality -> straight-through Gumbel-softmax (temperature 5), the
  decision being the last column of the hard sample.
- Main net: each backbone's segment logits times the segment's decision,
  summed with learnable late-fusion weights (M - 1 parameters, the last
  weight their complement), then the mean over segments.
- Loss: cross entropy; in the policy phase plus the blockdrop penalty
  (squared per-video selection rate gated on top-1 correctness, plus
  gammas times the error rate).
- Updates: SGD with momentum 0.9 and L2 weight decay in the gradient (main
  net), Adam (b1 0.9, b2 0.999, eps 1e-8, L2 in the gradient; policy net).

Noise is drawn as the deployment does, from generators the caller seeds:
one (M, N, 2) exponential draw a segment for the Gumbel noise, and one
uniform draw of the pooled features' shape a backbone for dropout, in the
order the backbones run.

``Prec`` rounds the operands and results of every convolution and matmul,
where the program keeps them in its compute dtype: ``Prec()`` is float32
(the reference), ``Prec("fp8")`` rounds them to float8 e4m3 and the
gradients flowing back through them to e5m2, each with a per-tensor scale
(the control, one precision below the bfloat16 that the configurations
state).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
RESNET50_BLOCKS = (3, 4, 6, 3)
# MobileNetV2: expansion, channels, blocks, stride
MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
MBV2_POOL_BEFORE = (64, 160)
MBV2_LAST = 1280
JOINT = 2048
LSTM_HIDDEN = 256
CHANNELS = {"rgb": 3, "flow": 10, "rgbdiff": 15, "sound": 1}
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Spec:
    """A configuration's ``reference`` block (benchmark/configs/*.json)."""

    modality: Tuple[str, ...]
    num_classes: int
    frames: int               # frames a segment
    segments: int             # segments a training clip
    input_size: int
    policy_input_size: int
    audio_length: float
    resampling_rate: int
    canvas: Tuple[int, int]
    scale_range: Tuple[int, int]
    dropout: float
    temperature: float
    gammas: float
    cost_weights: Tuple[float, ...]
    lr: float
    p_lr: float
    momentum: float
    weight_decay: float

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        d = dict(d)
        for k in ("modality", "canvas", "scale_range", "cost_weights"):
            d[k] = tuple(d[k])
        return cls(**d)

    @property
    def policy_modality(self) -> Tuple[str, ...]:
        return split_modalities(self.modality)[0]

    @property
    def main_modality(self) -> Tuple[str, ...]:
        return split_modalities(self.modality)[1]


def split_modalities(modality: Sequence[str]):
    """(policy, main) modalities: with both rgbdiff and flow the policy
    reads rgbdiff as the cheap proxy of flow, the main net flow
    (IBM/AdaMML models/adamml.py:143-152)."""
    modality = tuple(modality)
    if "rgbdiff" in modality and "flow" in modality:
        return (tuple(m for m in modality if m != "flow"),
                tuple(m for m in modality if m != "rgbdiff"))
    return modality, modality


# -- parameters ------------------------------------------------------------

def _bn(name: str, c: int) -> List[tuple]:
    return [(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero"),
            (f"{name}.running_mean", (c,), "zero"),
            (f"{name}.running_var", (c,), "one")]


def _mbv2_specs(p: str, in_ch: int, classes: Optional[int]) -> List[tuple]:
    out = [(f"{p}.features_0.conv.weight", (32, in_ch, 3, 3), "fan_in")]
    out += _bn(f"{p}.features_0.bn", 32)
    inp, idx = 32, 1
    for t, c, n, _ in MBV2:
        for _ in range(n):
            q, hidden = f"{p}.features_{idx}", inp * t
            if t != 1:
                out.append((f"{q}.pw.conv.weight", (hidden, inp, 1, 1),
                            "fan_in"))
                out += _bn(f"{q}.pw.bn", hidden)
            out.append((f"{q}.dw.conv.weight", (hidden, 1, 3, 3), "fan_in"))
            out += _bn(f"{q}.dw.bn", hidden)
            out.append((f"{q}.pw_linear.weight", (c, hidden, 1, 1), "fan_in"))
            out += _bn(f"{q}.bn_linear", c)
            inp, idx = c, idx + 1
    out.append((f"{p}.conv_last.conv.weight", (MBV2_LAST, inp, 1, 1),
                "fan_in"))
    out += _bn(f"{p}.conv_last.bn", MBV2_LAST)
    if classes is not None:
        out += [(f"{p}.classifier.weight", (classes, MBV2_LAST), "fan_in"),
                (f"{p}.classifier.bias", (classes,), "zero")]
    return out


def _resnet50_specs(p: str, in_ch: int, classes: int) -> List[tuple]:
    out = [(f"{p}.conv1.weight", (64, in_ch, 7, 7), "fan_in")]
    out += _bn(f"{p}.bn1", 64)
    inplanes = 64
    for stage, blocks in enumerate(RESNET50_BLOCKS):
        planes = 64 * 2 ** stage
        for b in range(blocks):
            q = f"{p}.layer{stage + 1}_{b}"
            out.append((f"{q}.cb1.conv.weight", (planes, inplanes, 1, 1),
                        "fan_in"))
            out += _bn(f"{q}.cb1.bn", planes)
            out.append((f"{q}.cb2.conv.weight", (planes, planes, 3, 3),
                        "fan_in"))
            out += _bn(f"{q}.cb2.bn", planes)
            out.append((f"{q}.cb3.conv.weight", (planes * 4, planes, 1, 1),
                        "fan_in"))
            out += _bn(f"{q}.cb3.bn", planes * 4)
            if b == 0:
                out.append((f"{q}.downsample.conv.weight",
                            (planes * 4, inplanes, 1, 1), "fan_in"))
                out += _bn(f"{q}.downsample.bn", planes * 4)
            inplanes = planes * 4
    out += [(f"{p}.fc.weight", (classes, 2048), "fan_in"),
            (f"{p}.fc.bias", (classes,), "zero")]
    return out


def param_specs(spec: Spec) -> List[tuple]:
    """(name, shape, init) of every parameter and BN statistic. init:
    "fan_in" N(0, 1/fan_in), "zero", "one", "lf" 1/M."""
    pm, mm = spec.policy_modality, spec.main_modality
    out: List[tuple] = []
    for m in pm:
        out += _mbv2_specs(f"policy_net.net_{m}", CHANNELS[m], None)
    out += [("policy_net.joint_fc1.weight", (JOINT, MBV2_LAST * len(pm)),
             "fan_in"),
            ("policy_net.joint_fc1.bias", (JOINT,), "zero"),
            ("policy_net.joint_fc2.weight", (JOINT, JOINT), "fan_in"),
            ("policy_net.joint_fc2.bias", (JOINT,), "zero"),
            ("policy_net.lstm.ih.weight",
             (4 * LSTM_HIDDEN, JOINT + 2 * len(pm)), "fan_in"),
            ("policy_net.lstm.ih.bias", (4 * LSTM_HIDDEN,), "zero"),
            ("policy_net.lstm.hh.weight", (4 * LSTM_HIDDEN, LSTM_HIDDEN),
             "fan_in"),
            ("policy_net.lstm.hh.bias", (4 * LSTM_HIDDEN,), "zero")]
    for i in range(len(pm)):
        out += [(f"policy_net.lstm.fc_{i}.weight", (2, LSTM_HIDDEN),
                 "fan_in"),
                (f"policy_net.lstm.fc_{i}.bias", (2,), "zero")]
    out.append(("main_net.lf_weights", (len(mm) - 1,), "lf"))
    for m in mm:
        if m == "sound":
            out += _mbv2_specs(f"main_net.net_{m}", 1, spec.num_classes)
        else:
            out += _resnet50_specs(f"main_net.net_{m}", CHANNELS[m],
                                   spec.num_classes)
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def make_weights(specs: List[tuple], seed: int,
                 device: torch.device) -> Tensors:
    """Every tensor of ``specs`` on ``device``: the N(0, 1/fan_in) leaves
    from one standard-normal draw of a generator seeded with ``seed``, cut
    in the order of ``specs`` and scaled; the rest filled."""
    device = torch.device(device)
    drawn = sum(math.prod(s) for _, s, k in specs if k == "fan_in")
    if device.type == "meta":
        z = torch.empty(drawn, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        z = torch.randn(drawn, generator=gen, device=device)
    m = sum(1 for _, s, k in specs if k == "lf")
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "fan_in":
            n = math.prod(shape)
            out[name] = (z[at:at + n].view(shape)
                         / math.sqrt(math.prod(shape[1:])))
            at += n
        elif kind == "lf":
            out[name] = torch.full(shape, 1.0 / (shape[0] + 1),
                                   device=device)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                   device=device)
    return out


# -- precision -------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to a float8 format with a per-tensor scale to its largest
    value."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient: the hybrid float8 recipe of mixed
    precision training."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Prec:
    """Rounding of convolution and matmul operands and results: none
    (float32), or float8 with a per-tensor scale, e4m3 for the values and
    e5m2 for the gradients that flow back through them."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "fp32" else _Fp8.apply(x)


def step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (2 ** 63)


def noise(device, seed: int, step: int):
    """(Gumbel, dropout) generators of step ``step`` of a run seeded
    ``seed``: seeded step_seed(step_seed(seed, step), j), j = 0, 1, the
    convention by which the deployment draws each step's noise."""
    base = step_seed(seed, step)
    return tuple(torch.Generator(device=device).manual_seed(
        step_seed(base, j)) for j in (0, 1))


# -- layers ----------------------------------------------------------------

class Net:
    """One forward's context: parameters, statistics, mode, precision, and
    the statistics the forward makes (``new_stats``, written once each,
    so a checkpointed block's recompute leaves them as they were)."""

    def __init__(self, params: Tensors, stats: Tensors, *, train: bool,
                 prec: Prec, segments: int, dropout: float,
                 ckpt: bool = False):
        self.p, self.stats, self.train = params, stats, train
        self.prec, self.segments, self.ckpt = prec, segments, ckpt
        self.dropout_p = dropout
        self.new_stats: Tensors = {}

    def conv(self, x, name, stride=1, groups=1):
        w = self.p[name]
        return self.prec(F.conv2d(self.prec(x), self.prec(w), stride=stride,
                                  padding=w.shape[-1] // 2, groups=groups))

    def linear(self, x, name):
        return self.prec(F.linear(self.prec(x),
                                  self.prec(self.p[name + ".weight"]),
                                  self.p[name + ".bias"]))

    def bn(self, x, name, frames):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if not self.train:
            rm = self.stats[name + ".running_mean"]
            rv = self.stats[name + ".running_var"]
            return ((x - rm[:, None, None]) / torch.sqrt(rv + BN_EPS)[
                :, None, None] * w[:, None, None] + b[:, None, None])
        rows, c, h, wd = x.shape
        s = self.segments
        if s > 1 and rows % (s * frames) == 0:
            g = x.reshape(rows // (s * frames), s, frames, c, h, wd)
            red = (0, 2, 4, 5)
        else:
            s, g, red = 1, x.reshape(rows, 1, 1, c, h, wd), (0, 2, 4, 5)
        mean = g.mean(red)                                     # (S, C)
        var = (g * g).mean(red) - mean * mean    # flax's fast variance
        y = ((g - mean[None, :, None, :, None, None])
             / torch.sqrt(var + BN_EPS)[None, :, None, :, None, None]
             * w[:, None, None] + b[:, None, None])
        if name not in self.new_stats:
            count = rows // s * h * wd
            unbiased = var.detach() * (count / (count - 1))
            fold = (1 - BN_MOMENTUM) * BN_MOMENTUM ** torch.arange(
                s - 1, -1, -1, dtype=torch.float32, device=x.device)
            for key, moment in (("running_mean", mean.detach()),
                                ("running_var", unbiased)):
                old = self.stats[f"{name}.{key}"]
                self.new_stats[f"{name}.{key}"] = (
                    old * BN_MOMENTUM ** s + fold @ moment)
        return y.reshape(rows, c, h, wd)

    def dropout(self, x, gen):
        p = self.dropout_p
        if not self.train or p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
        return torch.where(keep, x / (1 - p), torch.zeros_like(x))

    def maybe_ckpt(self, fn, x):
        if self.ckpt and self.train and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)


def temporal_max_pool(x: torch.Tensor, frames: int) -> torch.Tensor:
    """Max over frames, kernel 3, stride 2, padding 1, on rows (clip,
    frame)-ordered; returns rows with the pooled frame count."""
    rows = x.shape[0]
    v = x.reshape((rows // frames, frames) + tuple(x.shape[1:]))
    outs = [v[:, max(0, 2 * k - 1):min(frames, 2 * k + 2)].amax(1)
            for k in range((frames - 1) // 2 + 1)]
    out = torch.stack(outs, 1)
    return out.reshape((-1,) + tuple(x.shape[1:]))


def resnet50(net: Net, p: str, x: torch.Tensor, frames: int, gen):
    """x: (rows, C, H, W) with rows (clip, frame); returns (clips, K)."""
    def stem(t):
        t = torch.relu(net.bn(net.conv(t, f"{p}.conv1.weight", 2),
                              f"{p}.bn1", frames))
        return F.max_pool2d(t, 3, 2, 1)

    x = net.maybe_ckpt(stem, x)
    cur = frames
    for stage, blocks in enumerate(RESNET50_BLOCKS):
        for b in range(blocks):
            q = f"{p}.layer{stage + 1}_{b}"
            stride = 2 if (stage > 0 and b == 0) else 1

            def block(t, q=q, stride=stride, b=b, cur=cur):
                out = torch.relu(net.bn(net.conv(t, f"{q}.cb1.conv.weight"),
                                        f"{q}.cb1.bn", cur))
                out = torch.relu(net.bn(net.conv(out, f"{q}.cb2.conv.weight",
                                                 stride), f"{q}.cb2.bn", cur))
                out = net.bn(net.conv(out, f"{q}.cb3.conv.weight"),
                             f"{q}.cb3.bn", cur)
                idt = t if b else net.bn(net.conv(
                    t, f"{q}.downsample.conv.weight", stride),
                    f"{q}.downsample.bn", cur)
                return torch.relu(out + idt)

            x = net.maybe_ckpt(block, x)
        if stage < 3 and cur > 1:
            x = temporal_max_pool(x, cur)
            cur = (cur - 1) // 2 + 1
    feat = net.dropout(x.mean(dim=(2, 3)), gen)
    logits = net.linear(feat, f"{p}.fc")
    return logits.reshape(-1, cur, logits.shape[-1]).mean(1)


def mobilenet_v2(net: Net, p: str, x: torch.Tensor, frames: int, *,
                 temporal_pooling: bool, gen=None, head: bool = True):
    """x: (rows, C, H, W) with rows (clip, frame). head: (clips, K) logits;
    else (clips, frames out, 1280) features."""
    def cbr(t, name, stride=1, groups=1, cur=frames):
        return torch.clamp(net.bn(net.conv(t, name + ".conv.weight", stride,
                                           groups), name + ".bn", cur),
                           0.0, 6.0)

    x = cbr(x, f"{p}.features_0", 2)
    cur, inp, idx = frames, 32, 1
    for t, c, n, s in MBV2:
        for i in range(n):
            if temporal_pooling and i == 0 and c in MBV2_POOL_BEFORE \
                    and cur > 1:
                x = temporal_max_pool(x, cur)
                cur = (cur - 1) // 2 + 1
            q = f"{p}.features_{idx}"
            stride = s if i == 0 else 1
            out = x if t == 1 else cbr(x, f"{q}.pw", cur=cur)
            out = cbr(out, f"{q}.dw", stride, groups=inp * t, cur=cur)
            out = net.bn(net.conv(out, f"{q}.pw_linear.weight"),
                         f"{q}.bn_linear", cur)
            x = x + out if (stride == 1 and inp == c) else out
            inp, idx = c, idx + 1
    x = cbr(x, f"{p}.conv_last", cur=cur).mean(dim=(2, 3))
    if not head:
        return x.reshape(-1, cur, MBV2_LAST)
    logits = net.linear(net.dropout(x, gen), f"{p}.classifier")
    return logits.reshape(-1, cur, logits.shape[-1]).mean(1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(clips, F, H, W, C) -> (clips * F, C, H, W)."""
    n, f, h, w, c = x.shape
    return x.reshape(n * f, h, w, c).permute(0, 3, 1, 2).contiguous()


def policy_stream(x: torch.Tensor, size: int) -> torch.Tensor:
    """Every second frame, resized to size x size (bilinear, antialiased)."""
    n, s, f, h, w, c = x.shape
    sub = x[:, :, ::2]
    fp = sub.shape[2]
    t = sub.reshape(n * s * fp, h, w, c).permute(0, 3, 1, 2)
    t = F.interpolate(t.contiguous(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return t.permute(0, 2, 3, 1).reshape(n, s, fp, size, size, c)


def gumbel_decision(logits: torch.Tensor, tau: float, gen) -> torch.Tensor:
    """(M, N, 2) logits -> (M, N) straight-through hard decisions."""
    e = torch.empty(logits.shape, dtype=logits.dtype,
                    device=logits.device).exponential_(generator=gen)
    y_soft = torch.softmax((logits - e.log()) / tau, dim=-1)
    hard = F.one_hot(y_soft.argmax(-1), 2).to(logits.dtype)
    return (hard + (y_soft - y_soft.detach()))[..., -1]


def policy(net: Net, spec: Spec, inputs: Dict[str, torch.Tensor], gen):
    """Decisions (N, S, M) of the policy over the per-modality inputs
    (N, S, F, H, W, C)."""
    feats = []
    for m in spec.policy_modality:
        x = inputs[m]
        if m != "sound":
            x = policy_stream(x, spec.policy_input_size)
        n, s = x.shape[:2]
        f = mobilenet_v2(net, f"policy_net.net_{m}",
                         _nchw(x.reshape((n * s,) + tuple(x.shape[2:]))),
                         x.shape[2], temporal_pooling=True, head=False)
        feats.append(f.mean(1))
    joint = torch.cat(feats, -1)
    joint = torch.relu(net.linear(joint, "policy_net.joint_fc1"))
    joint = torch.relu(net.linear(joint, "policy_net.joint_fc2"))
    joint = joint.reshape(n, s, JOINT)
    mods = len(spec.policy_modality)
    h = joint.new_zeros(n, LSTM_HIDDEN)
    c, prev = torch.zeros_like(h), joint.new_zeros(n, 2 * mods)
    decisions = []
    for t in range(s):
        gates = (net.linear(torch.cat([joint[:, t], prev], -1),
                            "policy_net.lstm.ih")
                 + net.linear(h, "policy_net.lstm.hh"))
        i, f_, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f_) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        logits = torch.stack([net.linear(h, f"policy_net.lstm.fc_{k}")
                              for k in range(mods)])          # (M, N, 2)
        decisions.append(gumbel_decision(logits, spec.temperature, gen))
        prev = logits.permute(1, 0, 2).reshape(n, 2 * mods)
    return torch.stack(decisions).permute(2, 0, 1)           # (N, S, M)


def backbones(net: Net, spec: Spec, inputs: Dict[str, torch.Tensor],
              gen) -> List[torch.Tensor]:
    """Each main modality's segment logits (N * S, K), in order."""
    outs = []
    for m in spec.main_modality:
        x = inputs[m]
        n, s, f = x.shape[:3]
        rows = _nchw(x.reshape((n * s,) + tuple(x.shape[2:])))
        if m == "sound":
            outs.append(mobilenet_v2(net, f"main_net.net_{m}", rows, f,
                                     temporal_pooling=False, gen=gen))
        else:
            outs.append(resnet50(net, f"main_net.net_{m}", rows, f, gen))
    return outs


def fuse(net: Net, seg_logits: List[torch.Tensor],
         decisions: torch.Tensor) -> torch.Tensor:
    """Final logits (N, K): decision-masked segment logits fused with the
    late-fusion weights, then averaged over segments."""
    n, s = decisions.shape[:2]
    outs = [lg * decisions[:, :, i].reshape(n * s, 1)
            for i, lg in enumerate(seg_logits)]
    lf = net.p["main_net.lf_weights"]
    weights = torch.cat([lf, (1.0 - lf.sum())[None]])
    fused = (torch.stack(outs) * weights[:, None, None]).sum(0)
    return fused.reshape(n, s, -1).mean(1)


def forward(params: Tensors, stats: Tensors, spec: Spec,
            inputs: Dict[str, torch.Tensor], *, train: bool, gumbel,
            dropout=None, prec: Prec = Prec(), ckpt: bool = False,
            live: str = "main"):
    """(logits (N, K), decisions (N, S, M), new BN statistics). In train
    mode the subnet that is not ``live`` runs without gradients."""
    s = next(iter(inputs.values())).shape[1]
    net = Net(params, stats, train=train, prec=prec, segments=s,
              dropout=spec.dropout, ckpt=ckpt)
    grad = torch.is_grad_enabled()
    with torch.set_grad_enabled(grad and (not train or live == "policy")):
        decisions = policy(net, spec, inputs, gumbel)
    with torch.set_grad_enabled(grad and (not train or live == "main")):
        seg_logits = backbones(net, spec, inputs, dropout)
    return fuse(net, seg_logits, decisions), decisions, net.new_stats


def blockdrop_loss(decisions: torch.Tensor, logits: torch.Tensor,
                   target: torch.Tensor, cost_weights, gammas: float):
    correct = (logits.detach().argmax(-1) == target).float()
    sel = decisions.mean(1) ** 2                              # (N, M)
    w = torch.tensor(cost_weights, dtype=sel.dtype, device=sel.device)
    gated = (correct[:, None] * sel).mean(0)
    return (w[:sel.shape[1]] * gated).sum() + ((1 - correct) * gammas).mean()


class Trainer:
    """Train steps of one phase ("main": SGD on main_net.*, "policy": Adam
    on policy_net.*) from the given weights; the other subnet is frozen
    and its BN statistics move all the same."""

    def __init__(self, spec: Spec, weights: Tensors, phase: str, *,
                 prec: Prec = Prec(), ckpt: bool = True):
        self.spec, self.phase, self.prec, self.ckpt = spec, phase, prec, ckpt
        self.params = {k: v.clone() for k, v in weights.items()
                       if not is_statistic(k)}
        self.stats = {k: v.clone() for k, v in weights.items()
                      if is_statistic(k)}
        self.live = [k for k in self.params if k.startswith(f"{phase}_net.")]
        self.opt: Dict[str, Tensors] = {k: {} for k in self.live}
        self.t = 0

    def step(self, inputs, target, gumbel, dropout, cost_weights):
        """One step; returns (loss, {leaf: gradient as the update takes it,
        weight decay included})."""
        spec = self.spec
        for k in self.live:
            self.params[k].requires_grad_(True)
        logits, decisions, new_stats = forward(
            self.params, self.stats, spec, inputs, train=True, gumbel=gumbel,
            dropout=dropout, prec=self.prec, ckpt=self.ckpt, live=self.phase)
        loss = F.cross_entropy(logits, target.long())
        if self.phase == "policy":
            loss = loss + blockdrop_loss(decisions, logits, target,
                                         cost_weights, spec.gammas)
        grads = torch.autograd.grad(loss, [self.params[k] for k in self.live])
        self.t += 1
        taken = {}
        with torch.no_grad():
            for k, g in zip(self.live, grads):
                p = self.params[k].detach()
                g = g + spec.weight_decay * p
                taken[k] = g
                st = self.opt[k]
                if self.phase == "main":
                    st["buf"] = (g.clone() if "buf" not in st
                                 else spec.momentum * st["buf"] + g)
                    p = p - spec.lr * st["buf"]
                else:
                    b1, b2 = ADAM_BETAS
                    st["m"] = b1 * st.get("m", torch.zeros_like(p)) \
                        + (1 - b1) * g
                    st["v"] = b2 * st.get("v", torch.zeros_like(p)) \
                        + (1 - b2) * g * g
                    m_hat = st["m"] / (1 - b1 ** self.t)
                    v_hat = st["v"] / (1 - b2 ** self.t)
                    p = p - spec.p_lr * m_hat / (v_hat.sqrt() + ADAM_EPS)
                self.params[k] = p
            self.stats.update(new_stats)
        return float(loss.detach()), taken
