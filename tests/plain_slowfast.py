"""Plain SlowFast 8x8, ResNet-50 (Feichtenhofer, Fan, Malik, He, "SlowFast
Networks for Video Recognition", ICCV 2019, arXiv:1812.03982, Table 1;
PySlowFast's configs/Kinetics/SLOWFAST_8x8_R50.yaml): the forward, the
loss, the gradients and the SGD update of one train step, and the eval
forward, in float32, in plain torch.

Functional: parameters and BN statistics are dicts of tensors keyed by the
parameter names of the model under test, so one set of weights loads into
both. Activations are NCDHW and every convolution is ``F.conv3d``.

- Input (N, T, H, W, 3); the fast pathway takes all T frames, the slow one
  frames ``torch.linspace(0, T - 1, T // 4).long()``.
- Every conv is bias-free, padded by k // 2 on each axis, and followed by
  BN and, unless stated, ReLU. Stems: [1, 7, 7] (slow, 3 -> W) and
  [5, 7, 7] (fast, 3 -> W / 8), stride (1, 2, 2); max-pool [1, 3, 3],
  stride (1, 2, 2), padding (0, 1, 1).
- Lateral connections after the stem and res2-res4: conv [7, 1, 1],
  stride (4, 1, 1), C -> 2C of the fast pathway, BN, ReLU, concatenated
  after the slow channels.
- res2-res5 of 3, 4, 6, 3 bottlenecks: [kt, 1, 1] -> [1, 3, 3] with the
  stage's spatial stride (2 in res3-res5, first block) -> [1, 1, 1] (BN,
  no ReLU), plus the identity or, in a stage's first block, a [1, 1, 1]
  conv with the stride and BN; then ReLU. kt: slow 1, 1, 3, 3; fast 3.
  Widths: slow 64, 128, 256, 512 (x4 out), fast an eighth of them.
- Head: each pathway's mean over (T, H, W), concatenated, dropout, fc.
- Train-mode BN: the moments over (N, T, H, W), the variance biased for
  the normalize and unbiased for the running statistics, which move with
  momentum 0.9 (torch's 0.1): r <- 0.9 r + 0.1 x.
- Update: SGD with momentum and L2 weight decay in the gradient; the
  first step's momentum buffer is the gradient.

Dropout keeps an element where ``torch.rand(shape, generator) < 1 - p``
over the (N, features) head input, drawn from the generator the caller
seeds. ``prec`` is applied to every convolution's and matmul's operands
and results (identity: float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ALPHA = 4
BETA_INV = 8
FUSION_RATIO = 2
FUSION_KERNEL = 7
BLOCKS = (3, 4, 6, 3)
SLOW_TEMPORAL = (1, 1, 3, 3)
FAST_TEMPORAL = (3, 3, 3, 3)
STEM_TEMPORAL = {"slow": 1, "fast": 5}
STAGES = ("stem", "res2", "res3", "res4", "res5")
BN_EPS = 1e-5
BN_MOMENTUM = 0.9

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Spec:
    num_classes: int = 400
    width: int = 64          # the slow stem's channels
    frames: int = 32         # frames of a clip
    input_size: int = 224
    dropout: float = 0.5
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# -- parameters ------------------------------------------------------------

def _conv_bn(name: str, cout: int, cin: int, kernel) -> List[tuple]:
    return [(f"{name}.conv.weight", (cout, cin) + tuple(kernel), "conv"),
            (f"{name}.bn.weight", (cout,), "bn_scale"),
            (f"{name}.bn.bias", (cout,), "zero"),
            (f"{name}.bn.running_mean", (cout,), "zero"),
            (f"{name}.bn.running_var", (cout,), "one")]


def _fast_out(spec: Spec) -> List[int]:
    """The fast pathway's channels after the stem and res2-res4."""
    w = spec.width // BETA_INV
    return [w] + [w * 2 ** k * 4 for k in range(3)]


def param_specs(spec: Spec) -> List[tuple]:
    """(name, shape, kind) of every parameter and BN statistic. kind:
    "conv" (N(0, 2 / fan_out)), "bn_scale", "fc" (N(0, 0.01^2)), "zero",
    "one"."""
    out: List[tuple] = []
    fast_out = _fast_out(spec)
    for path, width, temporal in (
            ("fast", spec.width // BETA_INV, FAST_TEMPORAL),
            ("slow", spec.width, SLOW_TEMPORAL)):
        out += _conv_bn(f"{path}.stem", width, 3,
                        (STEM_TEMPORAL[path], 7, 7))
        inplanes = width
        for stage, count in enumerate(BLOCKS):
            planes = width * 2 ** stage
            kt = temporal[stage]
            for b in range(count):
                q = f"{path}.{STAGES[stage + 1]}_{b}"
                cin = inplanes
                if b == 0 and path == "slow":
                    cin += fast_out[stage] * FUSION_RATIO
                out += _conv_bn(f"{q}.cb1", planes, cin, (kt, 1, 1))
                out += _conv_bn(f"{q}.cb2", planes, planes, (1, 3, 3))
                out += _conv_bn(f"{q}.cb3", planes * 4, planes, (1, 1, 1))
                if b == 0:
                    out += _conv_bn(f"{q}.downsample", planes * 4, cin,
                                    (1, 1, 1))
                inplanes = planes * 4
    for k, c in enumerate(fast_out):
        out += _conv_bn(f"fuse.{STAGES[k]}", c * FUSION_RATIO, c,
                        (FUSION_KERNEL, 1, 1))
    feat = spec.width * 32 + spec.width // BETA_INV * 32
    out += [("fc.weight", (spec.num_classes, feat), "fc"),
            ("fc.bias", (spec.num_classes,), "zero")]
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def make_weights(specs: List[tuple], seed: int, device,
                 bn_scale_std: float = 0.1) -> Tensors:
    """Every tensor of ``specs`` on ``device``, from one standard-normal
    draw of a generator seeded with ``seed``, cut in the order of
    ``specs``: convs N(0, 2 / fan_out) (Kaiming, fan-out), BN scales
    1 + ``bn_scale_std`` z (the last BN of a block too, so that every
    conv's gradient is non-zero), fc N(0, 0.01^2); the rest filled."""
    device = torch.device(device)
    drawn = sum(math.prod(s) for _, s, k in specs
                if k in ("conv", "bn_scale", "fc"))
    if device.type == "meta":
        z = torch.empty(drawn, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        z = torch.randn(drawn, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind in ("conv", "bn_scale", "fc"):
            n = math.prod(shape)
            v = z[at:at + n].view(shape)
            at += n
            if kind == "conv":
                v = v * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
            elif kind == "bn_scale":
                v = 1.0 + bn_scale_std * v
            else:
                v = 0.01 * v
            out[name] = v
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                   device=device)
    return out


# -- layers ----------------------------------------------------------------

def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Net:
    """One forward's context: parameters, statistics, mode, rounding, and
    the statistics the forward makes (``new_stats``, written once each, so
    that a checkpointed block's recompute leaves them as they were)."""

    def __init__(self, params: Tensors, stats: Tensors, *, train: bool,
                 prec: Callable = _identity, ckpt: bool = False):
        self.p, self.stats, self.train = params, stats, train
        self.prec, self.ckpt = prec, ckpt
        self.new_stats: Tensors = {}

    def conv(self, x, name, stride=1):
        w = self.p[name]
        pad = tuple(k // 2 for k in w.shape[2:])
        return self.prec(F.conv3d(self.prec(x), self.prec(w), stride=stride,
                                  padding=pad))

    def bn(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        shape = (1, -1, 1, 1, 1)
        if not self.train:
            rm = self.stats[name + ".running_mean"]
            rv = self.stats[name + ".running_var"]
            return ((x - rm.view(shape)) / torch.sqrt(rv + BN_EPS).view(shape)
                    * w.view(shape) + b.view(shape))
        mean = x.mean(dim=(0, 2, 3, 4))
        var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3, 4))
        y = ((x - mean.view(shape)) / torch.sqrt(var + BN_EPS).view(shape)
             * w.view(shape) + b.view(shape))
        if name + ".running_mean" not in self.new_stats:
            count = x.numel() // x.shape[1]
            for key, moment in (("running_mean", mean.detach()),
                                ("running_var",
                                 var.detach() * (count / (count - 1)))):
                old = self.stats[f"{name}.{key}"]
                self.new_stats[f"{name}.{key}"] = (
                    BN_MOMENTUM * old + (1 - BN_MOMENTUM) * moment)
        return y

    def cbr(self, x, name, stride=1, relu=True):
        y = self.bn(self.conv(x, name + ".conv.weight", stride), name + ".bn")
        return torch.relu(y) if relu else y

    def maybe_ckpt(self, fn, x):
        if self.ckpt and self.train and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)


def slow_frames(t: int) -> torch.Tensor:
    return torch.linspace(0, t - 1, t // ALPHA).long()


def stem(net: Net, path: str, x: torch.Tensor) -> torch.Tensor:
    x = net.cbr(x, f"{path}.stem", (1, 2, 2))
    return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


def stage(net: Net, path: str, k: int, x: torch.Tensor) -> torch.Tensor:
    """res{k + 1} (k = 1..4) of one pathway."""
    for b in range(BLOCKS[k - 1]):
        q = f"{path}.{STAGES[k]}_{b}"
        s = 2 if k > 1 and b == 0 else 1

        def block(t, q=q, s=s, b=b):
            out = net.cbr(t, f"{q}.cb1")
            out = net.cbr(out, f"{q}.cb2", (1, s, s))
            out = net.cbr(out, f"{q}.cb3", relu=False)
            idt = t if b else net.cbr(t, f"{q}.downsample", (1, s, s),
                                      relu=False)
            return torch.relu(out + idt)

        x = net.maybe_ckpt(block, x)
    return x


def fuse(net: Net, k: int, fast: torch.Tensor,
         slow: torch.Tensor) -> torch.Tensor:
    lateral = net.cbr(fast, f"fuse.{STAGES[k]}", (ALPHA, 1, 1))
    return torch.cat([slow, lateral], dim=1)


def forward(params: Tensors, stats: Tensors, spec: Spec, x: torch.Tensor,
            *, train: bool, dropout: Optional[torch.Generator] = None,
            prec: Callable = _identity, ckpt: bool = False
            ) -> Tuple[torch.Tensor, Tensors]:
    """(logits (N, K), new BN statistics) of clips x (N, T, H, W, 3)."""
    net = Net(params, stats, train=train, prec=prec, ckpt=ckpt)
    x = x.to(params["fc.weight"].dtype).permute(0, 4, 1, 2, 3)
    idx = slow_frames(x.shape[2]).to(x.device)
    slow = net.maybe_ckpt(lambda t: stem(net, "slow", t),
                          x.index_select(2, idx))
    fast = net.maybe_ckpt(lambda t: stem(net, "fast", t), x)
    for k in range(1, 5):
        slow = fuse(net, k - 1, fast, slow)
        slow = stage(net, "slow", k, slow)
        fast = stage(net, "fast", k, fast)
    feat = torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], 1)
    p = spec.dropout
    if train and p > 0.0:
        keep = torch.rand(feat.shape, generator=dropout,
                          device=feat.device) < 1 - p
        feat = torch.where(keep, feat / (1 - p), torch.zeros_like(feat))
    logits = prec(F.linear(prec(feat), prec(params["fc.weight"]),
                           params["fc.bias"]))
    return logits, net.new_stats


class Trainer:
    """SGD train steps of every parameter from the given weights."""

    def __init__(self, spec: Spec, weights: Tensors, *,
                 prec: Callable = _identity, ckpt: bool = True):
        self.spec, self.prec, self.ckpt = spec, prec, ckpt
        self.params = {k: v.clone() for k, v in weights.items()
                       if not is_statistic(k)}
        self.stats = {k: v.clone() for k, v in weights.items()
                      if is_statistic(k)}
        self.live = list(self.params)
        self.buf: Tensors = {}

    def step(self, x, target, dropout=None, grad_hook=None):
        """One step; returns (loss, {leaf: gradient as the update takes it,
        weight decay included}). ``grad_hook(name, grad)`` may replace a
        leaf's gradient before the update (a planted fault)."""
        spec = self.spec
        for k in self.live:
            self.params[k].requires_grad_(True)
        logits, new_stats = forward(self.params, self.stats, spec, x,
                                    train=True, dropout=dropout,
                                    prec=self.prec, ckpt=self.ckpt)
        loss = F.cross_entropy(logits, target.long())
        grads = torch.autograd.grad(loss, [self.params[k] for k in self.live])
        taken = {}
        with torch.no_grad():
            for k, g in zip(self.live, grads):
                if grad_hook is not None:
                    g = grad_hook(k, g)
                p = self.params[k].detach()
                g = g + spec.weight_decay * p
                taken[k] = g
                self.buf[k] = (g.clone() if k not in self.buf
                               else spec.momentum * self.buf[k] + g)
                self.params[k] = p - spec.lr * self.buf[k]
            self.stats.update(new_stats)
        return float(loss.detach()), taken
