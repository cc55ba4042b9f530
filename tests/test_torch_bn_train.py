"""Train-mode grouped BN as one autograd function
(``ops/kernels/bn_train.py``), run on its plain versions on the CPU,
against the autograd of the composition ``models/norm.py`` used before the
kernels (``_oracle`` below: float32 moments by two means, the per-group
rsqrt and affine, ``addcmul``, the running statistics' fold by a matmul).
float64 agrees to 1e-10, float32 to its round-off, over R in {1, 2},
S in {1, 5}, ``seq_inner`` in {1, 8}, the global-moments fallback, an odd
C and sync-BN at one data shard: the output, ``(a, b)`` with
``return_affine``, the running statistics (none moved without
``update_stats``) and the gradients of x, scale and bias. A moment
reduction other than the identity is applied to the moments forward and to
their gradients backward. The plan of the card's four passes covers every
pixel of a group exactly once, at tiny shapes by its walk written out and
at flagship's by its arithmetic.
"""

import pytest
import torch

from adamml_tpu_torch.models.norm import EPSILON, MOMENTUM, GroupedBatchNorm
from adamml_tpu_torch.ops.kernels import bn_train as bnk
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

# (x shape, groups R, seq_groups S, seq_inner): the module falls back to
# global moments when the rows do not split into R x S x seq_inner
CASES = {
    "R1_S1": ((6, 3, 3, 16), 1, 1, 1),
    "R2_S1": ((8, 3, 2, 16), 2, 1, 1),
    "R1_S5": ((10, 2, 3, 16), 1, 5, 1),
    "R2_S5": ((20, 2, 2, 8), 2, 5, 1),
    "R1_S5_si8": ((80, 2, 2, 8), 1, 5, 8),
    "R2_S5_si8": ((160, 1, 2, 8), 2, 5, 8),
    "R2_S1_si8": ((32, 2, 2, 8), 2, 1, 8),
    "global_fallback": ((7, 3, 3, 8), 2, 5, 1),
    "odd_C": ((10, 3, 3, 7), 1, 5, 1),
    "two_dims": ((12, 24), 1, 3, 1),
}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _oracle(bn, x, return_affine, seq_groups, seq_inner, reduce=None):
    """The train-mode forward as models/norm.py composed it before the
    kernels, in x's precision for float64 (float32 otherwise), with its
    running-statistics fold; autograd gives its backward."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    n, c = x.shape[0], x.shape[-1]
    r, sq, si = max(1, bn.groups), max(1, seq_groups), max(1, seq_inner)
    if not (r * sq > 1 and n % (r * sq * si) == 0):
        r = sq = si = 1
    gshape = (r, n // (r * sq * si), sq, si) + tuple(x.shape[1:])
    red = (1, 3) + tuple(range(4, len(gshape) - 1))
    xf = x.to(acc).reshape(gshape)
    mean = xf.mean(red)
    meansq = (xf * xf).mean(red)
    count = x.numel() // (r * sq * c)
    if reduce is not None:
        mean, meansq = reduce(torch.stack([mean, meansq]))
    var = meansq - mean * mean
    if bn.update_stats:
        with torch.no_grad():
            m, s = MOMENTUM, mean.shape[1]
            v = var[0] * (count / (count - 1)) if count > 1 else var[0]
            w = (1.0 - m) * torch.pow(m, torch.arange(s - 1, -1, -1,
                                                      dtype=acc))
            bn.running_mean.mul_(m ** s).add_(w @ mean[0])
            bn.running_var.mul_(m ** s).add_(w @ v)
    a = bn.weight * torch.rsqrt(var + EPSILON)
    b = bn.bias - mean * a
    if return_affine:
        return a, b
    bshape = (r, 1, sq, 1) + (1,) * (len(gshape) - 5) + (c,)
    y = torch.addcmul(b.reshape(bshape), x.reshape(gshape),
                      a.reshape(bshape))
    return y.reshape(x.shape).to(x.dtype)


def _bn(c, groups, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    bn = GroupedBatchNorm(c, dtype=dtype, groups=groups).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g, dtype=dtype))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g, dtype=dtype))
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=g, dtype=dtype))
        bn.running_var.copy_(1 + torch.rand(c, generator=g, dtype=dtype))
    return bn


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    # an offset and a per-channel scale, so that E[x^2] - mean^2 cancels
    # as in a real activation
    c = shape[-1]
    x = (0.5 + torch.randn(shape, generator=g, dtype=dtype)
         * (0.5 + torch.rand(c, generator=g, dtype=dtype)))
    return x, g


def _close(got, want, dtype, what):
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= tol * scale, (what, err, scale)


def _run(which, case, dtype, return_affine, update_stats=True, sync=False,
         seed=0):
    """Forward and backward of one BN (the module's new path, or the
    oracle); the outputs, the input's and parameters' gradients, and the
    running statistics."""
    shape, groups, sq, si = CASES[case]
    bn = _bn(shape[-1], groups, dtype, seed)
    bn.update_stats = update_stats
    bn.sync = sync
    x0, g = _inputs(shape, dtype, seed + 1)
    x = x0.clone().requires_grad_(True)
    if which == "new":
        out = bn(x, True, return_affine, sq, si)
    else:
        out = _oracle(bn, x, return_affine, sq, si)
    outs = out if return_affine else (out,)
    cot = [torch.randn(o.shape, generator=g, dtype=dtype) for o in outs]
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    return ([o.detach() for o in outs],
            [x.grad, bn.weight.grad, bn.bias.grad],
            [bn.running_mean.clone(), bn.running_var.clone()])


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_output_matches_oracle(case, dtype):
    got, want = _run("new", case, dtype, False), _run("oracle", case, dtype,
                                                      False)
    assert got[0][0].dtype == dtype
    _close(got[0][0], want[0][0], dtype, "y")


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_affine_matches_oracle(case, dtype):
    got, want = _run("new", case, dtype, True), _run("oracle", case, dtype,
                                                     True)
    for name, g, w in zip("ab", got[0], want[0]):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, dtype, name)


@pytest.mark.parametrize("update_stats", [True, False],
                         ids=["update", "recompute"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_running_statistics_match_oracle(case, dtype, update_stats):
    got = _run("new", case, dtype, False, update_stats)
    want = _run("oracle", case, dtype, False, update_stats)
    start = _bn(CASES[case][0][-1], 1, dtype, 0)
    for name, g, w, s in zip(("mean", "var"), got[2], want[2],
                             (start.running_mean, start.running_var)):
        if update_stats:
            _close(g, w, dtype, name)
            assert not torch.equal(g, s)
        else:
            assert torch.equal(g, s)


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "return_affine"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_oracle(case, dtype, return_affine):
    got = _run("new", case, dtype, return_affine)
    want = _run("oracle", case, dtype, return_affine)
    for name, g, w in zip(("dx", "dweight", "dbias"), got[1], want[1]):
        assert g.dtype == w.dtype
        _close(g, w, dtype, name)


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "return_affine"])
@pytest.mark.parametrize("case", ["R1_S5", "R2_S5_si8", "global_fallback"])
def test_sync_bn_at_one_data_shard(case, return_affine):
    """``sync`` without a process group (one data shard): the moments go
    through the all-reduce's identity between the finalize's two halves,
    and everything equals the oracle's."""
    got = _run("new", case, torch.float64, return_affine, sync=True)
    want = _run("oracle", case, torch.float64, return_affine)
    for g, w in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
        _close(g, w, torch.float64, "sync")


def _mirror(t):
    """A self-adjoint stand-in for the data group's mean: each channel's
    moments averaged with the mirrored channel's."""
    return 0.5 * (t + t.flip(-1))


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "return_affine"])
def test_moment_reduction_forward_and_backward(return_affine):
    """A reduction of the stacked moments (sync-BN's all-reduce mean, here
    ``_mirror``) reaches the moments forward and their gradients backward
    as the oracle's autograd through it does."""
    shape, groups, sq, si = CASES["R2_S5"]
    res = []
    for which in ("new", "oracle"):
        bn = _bn(shape[-1], groups, torch.float64, 3)
        x0, g = _inputs(shape, torch.float64, 4)
        x = x0.clone().requires_grad_(True)
        if which == "new":
            geom = bnk.geometry(shape, groups, sq, si)
            out = bnk.grouped_bn_train(
                x, bn.weight, bn.bias, (bn.running_mean, bn.running_var),
                geom, geom.count / (geom.count - 1), MOMENTUM, EPSILON,
                _mirror, return_affine)
        else:
            out = _oracle(bn, x, return_affine, sq, si, reduce=_mirror)
        outs = out if return_affine else (out,)
        cot = [torch.randn(o.shape, generator=g, dtype=torch.float64)
               for o in outs]
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
        res.append([o.detach() for o in outs]
                   + [x.grad, bn.weight.grad, bn.bias.grad,
                      bn.running_mean, bn.running_var])
    for g, w in zip(*res):
        _close(g, w, torch.float64, "mirror")


# -- the card's plan ----------------------------------------------------------

def _lane_pixels(geom, pl, g, k, lane):
    """The pixel indices of x (row-major over (n, p)) that ``lane`` of the
    blocks of group ``g``, slab ``k`` visits, in its order: the kernels'
    walk (``csrc/bn_train.cu``: ``place_of``, ``elem_and_step``) written
    out."""
    run_len = geom.si * geom.p
    run_stride = geom.s * run_len
    rep, seg = divmod(g, geom.s)
    base = (rep * (geom.n // geom.r) + seg * geom.si) * geom.p
    lanes = pl["lanes"]
    step_runs, step_off = divmod(lanes, run_len)
    q0 = k * pl["slab"]
    q1 = min(q0 + pl["slab"], geom.count)
    q = q0 + lane
    run, off = divmod(q, run_len)
    out = []
    while q < q1:
        out.append(base + run * run_stride + off)
        off += step_off
        run += step_runs
        if off >= run_len:
            off -= run_len
            run += 1
        q += lanes
    return out


# tiny shapes whose walk is written out pixel by pixel: (geometry, itemsize)
PLAN_WALKS = [
    (bnk.Geom(20, 6, 64, 2, 5, 1), 2),
    (bnk.Geom(80, 4, 24, 1, 5, 8), 2),
    (bnk.Geom(10, 9, 7, 1, 5, 1), 2),
    (bnk.Geom(7, 1, 2048, 1, 1, 1), 2),
    (bnk.Geom(32, 5, 96, 2, 1, 8), 4),
    (bnk.Geom(6, 3, 1001, 1, 1, 1), 4),
]


@pytest.mark.parametrize("geom,itemsize", PLAN_WALKS,
                         ids=[f"{g.n}x{g.p}x{g.c}_R{g.r}S{g.s}si{g.si}"
                              for g, _ in PLAN_WALKS])
def test_plan_walk_covers_each_group_once(geom, itemsize):
    """Every pixel of x is visited by exactly one (slab, lane) of exactly
    its own group, at every channel slice's channels."""
    vec = bnk.vec_width(geom.c, itemsize)
    pl = bnk.plan(geom, vec, sms=4)
    assert pl["threads"] <= bnk.THREADS
    assert pl["ns"] * pl["tcg"] * vec >= geom.c
    assert (pl["ns"] - 1) * pl["tcg"] * vec < geom.c
    owner = torch.full((geom.n * geom.p,), -1, dtype=torch.long)
    for g in range(geom.g):
        for k in range(pl["k"]):
            for lane in range(pl["lanes"]):
                px = _lane_pixels(geom, pl, g, k, lane)
                assert px == sorted(px)
                assert bool((owner[px] == -1).all())
                owner[px] = g
    rows = torch.arange(geom.n)
    rep, seg = rows // (geom.n // geom.r), (rows // geom.si) % geom.s
    want = (rep * geom.s + seg).repeat_interleave(geom.p)
    assert torch.equal(owner, want)


# flagship's train-mode BN shapes at 18 clips x 5 segments x 8 frames: the
# ResNet-50 stem and its last stage, an audio MobileNetV2 layer, and the
# float32 and odd-C variants
PLAN_SHAPES = [
    (bnk.Geom(720, 56 * 56, 64, 1, 5, 8), 2),
    (bnk.Geom(90, 7 * 7, 2048, 1, 5, 1), 2),
    (bnk.Geom(90, 32 * 32, 144, 1, 5, 1), 2),
    (bnk.Geom(720, 56 * 56, 64, 1, 5, 8), 4),
    (bnk.Geom(90, 7 * 7, 2047, 1, 5, 1), 2),
]


@pytest.mark.parametrize("geom,itemsize", PLAN_SHAPES,
                         ids=[f"{g.n}x{g.p}x{g.c}_{i}B"
                              for g, i in PLAN_SHAPES])
def test_plan_at_flagship_shapes(geom, itemsize):
    """The slabs tile each group's pixels, the blocks fill 132 SMs at
    least once, no lane walks fewer than 8 pixels unless the group is
    that small, and the partials stay within 7% of x's bytes."""
    vec = bnk.vec_width(geom.c, itemsize)
    pl = bnk.plan(geom, vec)
    q = geom.count
    assert pl["k"] * pl["slab"] >= q > (pl["k"] - 1) * pl["slab"]
    assert pl["blocks"] >= bnk.H100_SMS
    assert pl["slab"] >= pl["lanes"] * bnk.LANE_PIXELS_MIN or pl["k"] == 1
    x_bytes = geom.n * geom.p * geom.c * itemsize
    assert pl["partials_bytes"] <= 0.07 * x_bytes
    assert pl["threads"] <= bnk.THREADS and pl["tcg"] <= 32
    # the walk's first and last pixels stay inside x
    last = _lane_pixels(geom, pl, geom.g - 1, pl["k"] - 1, 0)
    assert 0 <= last[-1] < geom.n * geom.p


def test_cpu_path_launches_no_kernel():
    before = dict(bnk.launch_counts)
    _run("new", "R2_S5", torch.float32, False)
    assert bnk.launch_counts == before
