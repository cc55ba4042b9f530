"""Plain MViTv2-S 16x4 (Li, Wu, Fan, Mangalam, Xiong, Malik, Feichtenhofer,
"MViTv2: Improved Multiscale Vision Transformers for Classification and
Detection", CVPR 2022, arXiv:2112.01526; PySlowFast's
configs/Kinetics/MVITv2_S_16x4.yaml and slowfast/models/attention.py): the
forward, the loss, the gradients and the AdamW update of one train step,
the eval forward, and the random-sized crops of a train batch, in float32,
in plain torch.

Functional: parameters are a dict of tensors keyed by the parameter names
of the model under test (PySlowFast's, but ``patch_embed`` and ``head`` for
its ``patch_embed.proj`` and ``head.projection``), so one set of weights
loads into both. Activations are tokens (N, L, C) with the cls token
first; the convolutions take NCDHW.

- Patch embedding: conv [3, 7, 7], stride (2, 4, 4), padding (1, 3, 3),
  with bias; its (T, H, W) grid flattened in that order; the cls token
  (1, 1, C) prepended. No absolute position embedding.
- 16 blocks (``geometry``): at blocks 1, 3 and 14 the width and the heads
  double and Q is pooled with stride (1, 2, 2); K and V are pooled with
  the adaptive stride, (1, 8, 8) divided by every Q stride so far; the
  head dim stays 96. Each block: x_n = LN1(x); attention(x_n); the skip
  is x, or where the width changes Linear(x_n) then max-pool [1, 3, 3],
  stride (1, 2, 2), padding (0, 1, 1) over the non-cls tokens;
  x = skip + drop_path(attention); x = x + drop_path(MLP(LN2(x))), MLP =
  fc1 (4x), exact GELU, fc2.
- Attention (``attention_pool``, ``cal_rel_pos_spatial``,
  ``cal_rel_pos_temporal``): qkv = Linear(C_in, 3 C_out) split into heads;
  Q, K and V each through its own depthwise conv [3, 3, 3] (padding 1, no
  bias, shared by the heads) over the non-cls tokens, the cls token put
  back, then LayerNorm(head dim) over every token; logits (q * scale) @ k^T,
  scale = head_dim^-0.5; to the non-cls rows and columns the decomposed
  relative positions rel_t + rel_h + rel_w of the pooled, unscaled q over
  the tables gathered by ``rel_dist``; softmax over keys; @ v; the pooled
  q added to the non-cls rows (residual pooling); heads merged; proj.
- Head: LayerNorm, the cls token, dropout, Linear. LayerNorm eps 1e-6.
- Drop path: per clip, kept where ``torch.rand(N, generator) < 1 - rate``
  and scaled by 1 / (1 - rate), rates linspace(0, drop_path, depth), a
  rate of 0 drawing nothing; the masks drawn in the order blocks 0-15,
  attention branch then MLP branch, then the head's dropout mask
  (``rand((N, C)) < 1 - p``), from the generator the caller seeds.
- Update: the gradients clipped to a global L2 norm (scale min(1, clip /
  (norm + 1e-6))), then AdamW (torch's: decoupled decay p <- p (1 - lr wd)
  first, betas (0.9, 0.999), eps 1e-8, bias-corrected), with no decay on
  1-D parameters (``ZERO_WD_1D_PARAM``).

``prec`` is applied to every convolution's, matmul's and einsum's operands
and results (identity: float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PATCH_KERNEL = (3, 7, 7)
PATCH_STRIDE = (2, 4, 4)
PATCH_PADDING = (1, 3, 3)
POOL_KERNEL = (3, 3, 3)
MLP_RATIO = 4
LN_EPS = 1e-6
BETAS = (0.9, 0.999)
EPS = 1e-8

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Spec:
    num_classes: int = 400
    embed_dim: int = 96
    num_heads: int = 1
    depth: int = 16
    transitions: Tuple[int, ...] = (1, 3, 14)   # width x2, Q stride 2
    kv_stride: int = 8          # the adaptive K/V stride of block 0
    frames: int = 16            # frames of a clip
    input_size: int = 224
    dropout: float = 0.5
    drop_path: float = 0.2
    lr: float = 4e-4
    weight_decay: float = 0.05
    clip: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        out = {k: v for k, v in d.items() if k in names}
        if "transitions" in out:
            out["transitions"] = tuple(out["transitions"])
        return cls(**out)


@dataclasses.dataclass(frozen=True)
class Block:
    dim_in: int
    dim_out: int
    heads: int
    stride_q: int               # spatial; temporal strides are 1
    stride_kv: int
    grid_in: Tuple[int, int, int]
    grid_q: Tuple[int, int, int]
    grid_kv: Tuple[int, int, int]
    drop: float


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def patch_grid(spec: Spec) -> Tuple[int, int, int]:
    t = _conv_out(spec.frames, PATCH_KERNEL[0], PATCH_STRIDE[0],
                  PATCH_PADDING[0])
    s = _conv_out(spec.input_size, PATCH_KERNEL[1], PATCH_STRIDE[1],
                  PATCH_PADDING[1])
    return t, s, s


def geometry(spec: Spec) -> List[Block]:
    """Every block's widths, heads, strides, grids and drop-path rate."""
    dim, heads, kv = spec.embed_dim, spec.num_heads, spec.kv_stride
    grid = patch_grid(spec)
    rates = torch.linspace(0, spec.drop_path, spec.depth).tolist()
    out = []
    for i in range(spec.depth):
        sq = 2 if i in spec.transitions else 1
        dim_out, heads = (dim * 2, heads * 2) if sq == 2 else (dim, heads)
        kv = max(kv // sq, 1)
        t, h, w = grid
        gq = (t, _conv_out(h, 3, sq, 1), _conv_out(w, 3, sq, 1))
        gkv = (t, _conv_out(h, 3, kv, 1), _conv_out(w, 3, kv, 1))
        out.append(Block(dim, dim_out, heads, sq, kv, grid, gq, gkv,
                         rates[i]))
        dim, grid = dim_out, gq
    return out


# -- parameters ------------------------------------------------------------

def _linear(name: str, cout: int, cin: int) -> List[tuple]:
    return [(f"{name}.weight", (cout, cin), "linear"),
            (f"{name}.bias", (cout,), "zero")]


def _ln(name: str, c: int) -> List[tuple]:
    return [(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero")]


def param_specs(spec: Spec) -> List[tuple]:
    """(name, shape, kind) of every parameter. kind: "linear" and "table"
    (N(0, 0.02^2), PySlowFast's trunc_normal_(std=0.02), whose cut at +-2
    lies 100 standard deviations out), "conv" (N(0, 1 / (3 fan_in)), the
    variance of torch's default uniform init of a conv's weight and
    bias), "one", "zero"."""
    c = spec.embed_dim
    out = [("patch_embed.weight", (c, 3) + PATCH_KERNEL, "conv"),
           ("patch_embed.bias", (c,), "conv"),
           ("cls_token", (1, 1, c), "table")]
    t = patch_grid(spec)[0]
    for i, g in enumerate(geometry(spec)):
        b, a = f"blocks.{i}", f"blocks.{i}.attn"
        d = g.dim_out // g.heads
        out += _ln(f"{b}.norm1", g.dim_in)
        out += _linear(f"{a}.qkv", 3 * g.dim_out, g.dim_in)
        for w in "qkv":
            out.append((f"{a}.pool_{w}.weight", (d, 1) + POOL_KERNEL,
                        "conv"))
            out += _ln(f"{a}.norm_{w}", d)
        sp = 2 * max(g.grid_q[1], g.grid_kv[1]) - 1
        out += [(f"{a}.rel_pos_h", (sp, d), "table"),
                (f"{a}.rel_pos_w", (sp, d), "table"),
                (f"{a}.rel_pos_t", (2 * t - 1, d), "table")]
        out += _linear(f"{a}.proj", g.dim_out, g.dim_out)
        out += _ln(f"{b}.norm2", g.dim_out)
        out += _linear(f"{b}.mlp.fc1", MLP_RATIO * g.dim_out, g.dim_out)
        out += _linear(f"{b}.mlp.fc2", g.dim_out, MLP_RATIO * g.dim_out)
        if g.dim_in != g.dim_out:
            out += _linear(f"{b}.proj", g.dim_out, g.dim_in)
        c = g.dim_out
    out += _ln("norm", c)
    out += _linear("head", spec.num_classes, c)
    return out


def _fan_in(name: str, shape, specs) -> int:
    if name.endswith(".weight"):
        return math.prod(shape[1:])
    w = dict((n, s) for n, s, _ in specs)[name[:-len("bias")] + "weight"]
    return math.prod(w[1:])


def make_weights(specs: List[tuple], seed: int, device) -> Tensors:
    """Every tensor of ``specs`` on ``device``, from one standard-normal
    draw of a generator seeded with ``seed``, cut in the order of
    ``specs`` and scaled by its kind; "one" and "zero" filled."""
    device = torch.device(device)
    drawn = sum(math.prod(s) for _, s, k in specs
                if k in ("linear", "table", "conv"))
    if device.type == "meta":
        z = torch.empty(drawn, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        z = torch.randn(drawn, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind in ("linear", "table", "conv"):
            n = math.prod(shape)
            v = z[at:at + n].view(shape)
            at += n
            std = (0.02 if kind != "conv" else
                   1.0 / math.sqrt(3.0 * _fan_in(name, shape, specs)))
            out[name] = v * std
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                   device=device)
    return out


# -- layers ----------------------------------------------------------------

def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Net:
    """One forward's context: parameters, mode, rounding, checkpointing."""

    def __init__(self, params: Tensors, *, train: bool,
                 prec: Callable = _identity, ckpt: bool = False):
        self.p, self.train, self.prec, self.ckpt = params, train, prec, ckpt

    def linear(self, x, name):
        return self.prec(F.linear(self.prec(x),
                                  self.prec(self.p[name + ".weight"]),
                                  self.p[name + ".bias"]))

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                            self.p[name + ".bias"], LN_EPS)

    def einsum(self, eq, a, b):
        return self.prec(torch.einsum(eq, self.prec(a), self.prec(b)))

    def maybe_ckpt(self, fn, x):
        if self.ckpt and self.train and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)


def rel_dist(q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size) indices into a relative-position table: i
    max(k/q, 1) - j max(q/k, 1) + (k - 1) max(q/k, 1)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    d = (torch.arange(q_size)[:, None] * q_ratio
         - torch.arange(k_size)[None, :] * k_ratio)
    d += (k_size - 1) * k_ratio
    return d.long()


def attention_pool(net: Net, t: torch.Tensor, name: str, grid,
                   stride: int) -> torch.Tensor:
    """(N, heads, L, d) -> pooled (N, heads, L', d) with its LayerNorm."""
    n, h, _, d = t.shape
    cls, sp = t[:, :, :1], t[:, :, 1:]
    sp = sp.reshape((n * h,) + tuple(grid) + (d,)).permute(0, 4, 1, 2, 3)
    sp = net.prec(F.conv3d(net.prec(sp), net.prec(net.p[f"{name}.weight"]),
                           stride=(1, stride, stride), padding=1, groups=d))
    sp = sp.reshape(n, h, d, -1).transpose(2, 3)
    return net.ln(torch.cat([cls, sp], 2),
                  name.replace(".pool_", ".norm_"))


def rel_pos(net: Net, attn: torch.Tensor, q: torch.Tensor, a: str, g: Block
            ) -> torch.Tensor:
    """The logits with the decomposed relative positions of the pooled q
    added to their non-cls rows and columns."""
    n, h, _, d = q.shape
    qt, qh, qw = g.grid_q
    kt, kh, kw = g.grid_kv
    rh = net.p[f"{a}.rel_pos_h"][rel_dist(qh, kh)]
    rw = net.p[f"{a}.rel_pos_w"][rel_dist(qw, kw)]
    rt = net.p[f"{a}.rel_pos_t"][rel_dist(qt, kt)]
    r_q = q[:, :, 1:].reshape(n, h, qt, qh, qw, d)
    rel_h = net.einsum("bythwc,hkc->bythwk", r_q, rh)
    rel_w = net.einsum("bythwc,wkc->bythwk", r_q, rw)
    rel_t = net.einsum("bythwc,tkc->bythwk", r_q, rt)
    sp = (attn[:, :, 1:, 1:].reshape(n, h, qt, qh, qw, kt, kh, kw)
          + rel_h[:, :, :, :, :, None, :, None]
          + rel_w[:, :, :, :, :, None, None, :]
          + rel_t[:, :, :, :, :, :, None, None])
    sp = sp.reshape(n, h, qt * qh * qw, kt * kh * kw)
    return torch.cat([attn[:, :, :1],
                      torch.cat([attn[:, :, 1:, :1], sp], 3)], 2)


def attention(net: Net, a: str, g: Block, x: torch.Tensor) -> torch.Tensor:
    n, length, _ = x.shape
    d = g.dim_out // g.heads
    qkv = net.linear(x, f"{a}.qkv").reshape(n, length, 3, g.heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q = attention_pool(net, q, f"{a}.pool_q", g.grid_in, g.stride_q)
    k = attention_pool(net, k, f"{a}.pool_k", g.grid_in, g.stride_kv)
    v = attention_pool(net, v, f"{a}.pool_v", g.grid_in, g.stride_kv)
    attn = net.prec(net.prec(q * d ** -0.5)
                    @ net.prec(k.transpose(-2, -1)))
    attn = rel_pos(net, attn, q, a, g).softmax(dim=-1)
    out = net.prec(net.prec(attn) @ net.prec(v))
    out = torch.cat([out[:, :, :1], out[:, :, 1:] + q[:, :, 1:]], 2)
    return net.linear(out.transpose(1, 2).reshape(n, -1, g.dim_out),
                      f"{a}.proj")


def max_pool_skip(x: torch.Tensor, grid) -> torch.Tensor:
    n, _, c = x.shape
    sp = x[:, 1:].reshape((n,) + tuple(grid) + (c,)).permute(0, 4, 1, 2, 3)
    sp = F.max_pool3d(sp, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    return torch.cat([x[:, :1], sp.flatten(2).transpose(1, 2)], 1)


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float
              ) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep.view(-1, 1, 1), x / (1 - rate),
                       torch.zeros_like(x))


def block(net: Net, i: int, g: Block, x: torch.Tensor, masks
          ) -> torch.Tensor:
    b = f"blocks.{i}"
    xn = net.ln(x, f"{b}.norm1")
    att = attention(net, f"{b}.attn", g, xn)
    skip = x if g.dim_in == g.dim_out else net.linear(xn, f"{b}.proj")
    if g.stride_q > 1:
        skip = max_pool_skip(skip, g.grid_in)
    x = skip + drop_path(att, masks[0], g.drop)
    hid = F.gelu(net.linear(net.ln(x, f"{b}.norm2"), f"{b}.mlp.fc1"))
    return x + drop_path(net.linear(hid, f"{b}.mlp.fc2"), masks[1], g.drop)


def forward(params: Tensors, spec: Spec, x: torch.Tensor, *, train: bool,
            dropout: Optional[torch.Generator] = None,
            prec: Callable = _identity, ckpt: bool = False) -> torch.Tensor:
    """Logits (N, K) of clips x (N, T, H, W, 3)."""
    net = Net(params, train=train, prec=prec, ckpt=ckpt)
    x = x.to(params["cls_token"].dtype).permute(0, 4, 1, 2, 3)
    x = prec(F.conv3d(prec(x), prec(params["patch_embed.weight"]),
                      params["patch_embed.bias"], stride=PATCH_STRIDE,
                      padding=PATCH_PADDING))
    n = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([params["cls_token"].expand(n, -1, -1), x], 1)
    for i, g in enumerate(geometry(spec)):
        masks = [torch.rand(n, generator=dropout, device=x.device)
                 < 1 - g.drop if train and g.drop > 0 else None
                 for _ in range(2)]
        x = net.maybe_ckpt(lambda t, i=i, g=g, m=masks: block(net, i, g, t, m),
                           x)
    feat = net.ln(x, "norm")[:, 0]
    p = spec.dropout
    if train and p > 0.0:
        keep = torch.rand(feat.shape, generator=dropout,
                          device=feat.device) < 1 - p
        feat = torch.where(keep, feat / (1 - p), torch.zeros_like(feat))
    return net.linear(feat, "head")


class Trainer:
    """AdamW train steps of every parameter from the given weights."""

    def __init__(self, spec: Spec, weights: Tensors, *,
                 prec: Callable = _identity, ckpt: bool = True):
        # float32 matmuls and convolutions on a card, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec, self.prec, self.ckpt = spec, prec, ckpt
        self.params = {k: v.clone() for k, v in weights.items()}
        self.live = list(self.params)
        self.m: Tensors = {}
        self.v: Tensors = {}
        self.t = 0

    def step(self, x, target, dropout=None, grad_hook=None):
        """One step; returns (loss, {leaf: gradient as the update takes
        it, after the clip}). ``grad_hook(name, grad)`` may replace a
        leaf's clipped gradient (a planted fault)."""
        spec = self.spec
        for k in self.live:
            self.params[k].requires_grad_(True)
        logits = forward(self.params, spec, x, train=True, dropout=dropout,
                         prec=self.prec, ckpt=self.ckpt)
        loss = F.cross_entropy(logits, target.long())
        grads = torch.autograd.grad(loss, [self.params[k] for k in self.live])
        taken = {}
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            coef = min(1.0, spec.clip / (float(norm) + 1e-6))
            for k, g in zip(self.live, grads):
                g = g * coef
                if grad_hook is not None:
                    g = grad_hook(k, g)
                taken[k] = g
                p = self.params[k].detach()
                if p.dim() > 1:
                    p = p * (1 - spec.lr * spec.weight_decay)
                m = b1 * self.m.get(k, torch.zeros_like(g)) + (1 - b1) * g
                v = b2 * self.v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
                self.m[k], self.v[k] = m, v
                denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)) + EPS
                self.params[k] = p - spec.lr * (m / (1 - b1 ** self.t)) / denom
        return float(loss.detach()), taken


# -- data ------------------------------------------------------------------

def random_sized_crops(hw: np.ndarray, rng: np.random.RandomState,
                       input_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """A batch's (x, y, w, h) crops and flips, Inception's random-sized
    crop: up to 10 tries of an area uniform in [0.08, 1] of the image and
    an aspect uniform in [3/4, 4/3] (sides swapped with probability 1/2),
    the corner uniform over whole pixels; after 10 misses a short side
    scaled to input_size and a random input_size square of it; then a flip
    with probability 1/2. The draws, in order, from ``rng``."""
    crops = np.zeros((len(hw), 4), np.float32)
    flips = np.zeros((len(hw),), bool)
    for i, (h, w) in enumerate(hw.tolist()):
        crops[i] = _random_sized(int(h), int(w), input_size, rng)
        flips[i] = rng.random_sample() < 0.5
    return crops, flips


def _random_sized(h: int, w: int, size: int, rng) -> tuple:
    area = float(w) * float(h)
    for _ in range(10):
        target = rng.uniform(0.08, 1.0) * area
        aspect = rng.uniform(3.0 / 4.0, 4.0 / 3.0)
        cw = int(round(math.sqrt(target * aspect)))
        ch = int(round(math.sqrt(target / aspect)))
        if rng.random_sample() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            return (float(rng.randint(0, w - cw + 1)),
                    float(rng.randint(0, h - ch + 1)), float(cw), float(ch))
    f = size / min(h, w)
    sw, sh = ((int(size * w / h), size) if h <= w
              else (size, int(size * h / w)))
    x1 = rng.randint(0, max(sw - size, 0) + 1) / f
    y1 = rng.randint(0, max(sh - size, 0) + 1) / f
    return float(x1), float(y1), size / f, size / f
