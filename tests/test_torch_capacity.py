"""PyTorch port, eval-capacity conditional compute, against the JAX package:
``JointMainNet``'s packing (``eval_capacity`` < 1: per block, the selected
rows by a stable descending argsort, the backbone on ``cap`` rows only, the
logits scattered back) and ``validate``'s ``capacity_dropped`` count
(tests/test_models.py, tests/test_engine.py and
tests/test_capacity_sharded.py mirrored).

The decisions are given explicitly as exact 0/1 (JAX's straight-through
decisions can sit one ulp below 1, ROADMAP C), and the weights go across
with load_flax_variables. Float32; logits within 1e-4, as
tests/test_torch_heads.py holds the unpacked net.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adamml_tpu.models.joint_net import JointMainNet as JJointMainNet
from adamml_tpu.train import engine as jengine
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models.joint_net import JointMainNet
from adamml_tpu_torch.models.model_builder import _capacity_groups
from adamml_tpu_torch.train import engine as tengine

from torch_parity import flax_variables, one_torch_thread, t  # noqa: F401

B = 8          # rows: clips x segments folded
TOL = 1e-4
MODALITY = ("rgb", "sound")


def _dec(rgb_on, sound_on):
    d = np.zeros((2, B), np.float32)
    d[0, list(rgb_on)] = 1.0
    d[1, list(sound_on)] = 1.0
    return d


# (capacity, groups, rgb rows on, sound rows on): at c = 0.5, G = 1 cap is 4
# of 8; at G = 2 two of each block of 4; at c = 0.25 two of 8
CASES = {
    "c0.5-G1-below": (0.5, 1, [1, 4, 6], [0, 7]),
    "c0.5-G1-at": (0.5, 1, [0, 2, 5, 7], [1, 2, 3, 4]),
    "c0.5-G1-above": (0.5, 1, [0, 1, 3, 4, 6, 7], [2, 3, 5]),
    "c0.5-G1-all-ties": (0.5, 1, range(B), range(B)),
    "c0.5-G1-none": (0.5, 1, [], [6]),
    "c0.5-G2-mixed": (0.5, 2, [0, 1, 2, 5], [4, 5, 6, 7]),
    "c0.25-G1-above": (0.25, 1, [1, 2, 3], [0, 5]),
    "c1.0-no-packing": (1.0, 1, [0, 3, 4, 5], [1, 6]),
}


@pytest.fixture(scope="module")
def nets():
    """The inputs, the flax weights, and per (capacity, groups) the jitted
    JAX net and the port's net with those weights."""
    rs = np.random.RandomState(21)
    m_x = [rs.randn(B, 2, 32, 32, 3).astype(np.float32),
           rs.randn(B, 1, 64, 32, 1).astype(np.float32)]
    jx = [jnp.asarray(v) for v in m_x]
    kw = dict(modality=MODALITY, depth=18, num_classes=5)
    v = flax_variables(JJointMainNet(dtype=jnp.float32, **kw), rs, jx,
                       jnp.ones((2, B)), train=False)
    built = {}

    def get(c, g):
        if (c, g) not in built:
            jmod = JJointMainNet(dtype=jnp.float32, eval_capacity=c,
                                 capacity_groups=g, **kw)
            jfn = jax.jit(lambda d: jmod.apply(v, jx, d, train=False))
            tmod = load_flax_variables(
                JointMainNet(eval_capacity=c, capacity_groups=g, **kw),
                v["params"], v["batch_stats"])
            built[(c, g)] = (jfn, tmod)
        return built[(c, g)]

    return m_x, get


def _executed(dec, c, g):
    """Decisions of the rows packing runs: per block, the first cap selected
    rows in index order (tests/test_capacity_sharded.py)."""
    out = np.zeros_like(dec)
    bl = dec.shape[1] // g
    cap = max(1, int(round(c * bl)))
    for m in range(dec.shape[0]):
        for b in range(g):
            on = [i for i in range(b * bl, (b + 1) * bl) if dec[m, i]][:cap]
            out[m, on] = 1.0
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_packing_matches_jax(nets, case):
    """The packed logits against JAX's on the same weights and decisions;
    rows beyond a block's capacity give 0 on both sides; and the port's
    packed run equals its unpacked run with the decisions the packing
    executes (the backbone on fewer rows computes the same rows)."""
    c, g, rgb_on, sound_on = CASES[case]
    m_x, get = nets
    dec = _dec(rgb_on, sound_on)
    jfn, tmod = get(c, g)
    want = np.asarray(jfn(jnp.asarray(dec)))
    calls = []
    hooks = [getattr(tmod, f"net_{m}").register_forward_hook(
        lambda mod, args, out: calls.append(args[0].shape[0]))
        for m in MODALITY]
    with torch.no_grad():
        got = tmod([t(x) for x in m_x], t(dec))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    cap = max(1, int(round(c * B / g)))
    assert calls == ([B, B] if c >= 1.0 else [g * cap, g * cap])

    _, full = get(1.0, 1)
    with torch.no_grad():
        masked = full([t(x) for x in m_x], t(_executed(dec, c, g)
                                           if c < 1.0 else dec))
    np.testing.assert_allclose(got.numpy(), masked.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_packing_gives_zero_rows_for_dropped_selections(nets):
    """All rows on at capacity 0.5 (one modality's backbone, rgb): 4 rows
    keep their logits, the 4 beyond capacity are exactly 0, the lowest
    indices run (a stable sort), as in tests/test_models.py."""
    m_x, get = nets
    _, tmod = get(0.5, 1)
    with torch.no_grad():
        lp = tmod._packed(0, t(m_x[0]), torch.ones(B))
    nonzero = (lp.abs().sum(dim=1) > 0).tolist()
    assert nonzero == [True] * 4 + [False] * 4


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_capacity_dropped_matches_jax(groups):
    """validate's count of selected segments that packing did not run, on
    the same raw (n, S, M) decisions of two batches, against JAX's
    validate. G = 3 divides no batch's rows, so both fall back to one
    block."""
    rs = np.random.RandomState(groups)
    n, s, m = 4, 2, 2
    decs = [(rs.rand(n, s, m) > 0.3).astype(np.float32) for _ in range(2)]
    logits = rs.randn(n, 5).astype(np.float32)
    target = np.arange(n) % 5

    def steps(lib):
        it = iter(decs)

        def step(state, inputs, tgt, rng):
            return lib(logits), lib(next(it)), lib(np.float32(1.0))
        return step

    kw = dict(modality=["rgb", "sound"], adamml=True, num_segments=s,
              eval_capacity=0.5, capacity_groups=groups)
    want = jengine.validate([{}, {}], lambda b: ([jnp.zeros((n,))],
                                                 jnp.asarray(target)),
                            steps(jnp.asarray), state=None, **kw)
    got = tengine.validate([{}, {}], lambda b: ([torch.zeros(n)],
                                                t(target)),
                           steps(torch.tensor), state=None, **kw)
    assert got["capacity_dropped"] == want["capacity_dropped"]
    assert sum(got["capacity_dropped"].values()) > 0
    kw["eval_capacity"] = None
    got = tengine.validate([{}], lambda b: ([torch.zeros(n)], t(target)),
                           steps(torch.tensor), state=None, **kw)
    assert "capacity_dropped" not in got


def test_capacity_groups_resolver():
    """One group on one card unless --capacity_groups pins it; below 1 is
    refused (adamml_tpu/models/model_builder.py:_capacity_groups)."""
    cfg = flagship_cfg(tiny=True)
    assert _capacity_groups(cfg) == 1
    cfg.model.capacity_groups = 4
    assert _capacity_groups(cfg) == 4
    cfg.model.capacity_groups = 0
    with pytest.raises(ValueError, match="capacity_groups"):
        _capacity_groups(cfg)
