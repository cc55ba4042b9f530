"""PyTorch port: PolicyNet (LSTM and per-segment heads) and JointMainNet
(logits fusion, mean and learnable weights; fc2 fusion) against the JAX
package, weights carried by load_flax_variables.

Gumbel noise is patched to zero-noise argmax on both sides, as
tests/test_parity_full.py does. Float32; logits within 1e-4, decisions
exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.models.joint_net import JointMainNet as JJointMainNet
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.model_builder import init_model
from adamml_tpu_torch.models.joint_net import JointMainNet

from torch_parity import (flax_variables, one_torch_thread, t,  # noqa: F401
                          zero_noise_jax, zero_noise_torch)

N, S = 3, 2
TOL = 1e-4


def _policy_inputs(rs):
    return [rs.randn(N, S, 2, 24, 24, 3).astype(np.float32),
            rs.randn(N, S, 1, 64, 32, 1).astype(np.float32)]


@pytest.fixture(scope="module", params=["lstm", None], ids=["lstm", "heads"])
def policy_pair(request):
    rs = np.random.RandomState(11)
    p_x = _policy_inputs(rs)
    jx = [jnp.asarray(v) for v in p_x]
    jmod = jpolicy.PolicyNet(modality=("rgb", "sound"),
                             causality_modeling=request.param,
                             dtype=jnp.float32, bn_seq_groups=S)
    v = flax_variables(jmod, rs, jx, 5.0, train=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolicy, "gumbel_decision", zero_noise_jax)
        dec, logits = jax.jit(lambda v, x: jmod.apply(
            v, x, 5.0, train=False,
            rngs={"gumbel": jax.random.PRNGKey(0)}))(v, jx)
    tmod = tpolicy.PolicyNet(("rgb", "sound"), [3, 1],
                             causality_modeling=request.param)
    load_flax_variables(tmod, v["params"], v["batch_stats"])
    return p_x, tmod, np.asarray(dec), np.asarray(logits)


def test_policy_net(policy_pair, monkeypatch):
    p_x, tmod, want_dec, want_logits = policy_pair
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
    with torch.no_grad():
        dec, logits = tmod([t(v) for v in p_x], 5.0)
    assert tuple(dec.shape) == (S, 2, N)
    assert tuple(logits.shape) == (S, 2, N, 2)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(dec.numpy(), want_dec)


def test_policy_net_noise_from_generator():
    """Real Gumbel noise: decisions are 0/1 and follow the generator's
    seed."""
    tmod = init_model(tpolicy.PolicyNet(("rgb", "sound"), [3, 1]), seed=3)
    p_x = [t(v) for v in _policy_inputs(np.random.RandomState(0))]
    runs = []
    for seed in (1, 1, 2):
        with torch.no_grad():
            dec, _ = tmod(p_x, 5.0, generator=torch.Generator().manual_seed(
                seed))
        assert set(dec.unique().tolist()) <= {0.0, 1.0}
        runs.append(dec)
    assert torch.equal(runs[0], runs[1])


JOINT_CASES = [("logits", True), ("logits", False), ("fc2", False)]


@pytest.mark.parametrize("fusion,learnable", JOINT_CASES,
                         ids=["logits-llf", "logits-mean", "fc2"])
def test_joint_main_net(fusion, learnable):
    rs = np.random.RandomState(5)
    b = N * S
    m_x = [rs.randn(b, 4, 32, 32, 3).astype(np.float32),
           rs.randn(b, 1, 64, 32, 1).astype(np.float32)]
    dec = None
    if fusion == "logits":
        dec = (rs.rand(2, b) > 0.4).astype(np.float32)
    jx = [jnp.asarray(v) for v in m_x]
    jdec = None if dec is None else jnp.asarray(dec)
    jmod = JJointMainNet(modality=("rgb", "sound"), depth=18, num_classes=5,
                         fusion_point=fusion, learnable_lf_weights=learnable,
                         dtype=jnp.float32, bn_seq_groups=S)
    v = flax_variables(jmod, rs, jx, jdec, train=False)
    want = jax.jit(lambda v, x, d: jmod.apply(v, x, d, train=False))(
        v, jx, jdec)
    tmod = JointMainNet(("rgb", "sound"), depth=18, num_classes=5,
                        fusion_point=fusion, learnable_lf_weights=learnable)
    load_flax_variables(tmod, v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tmod([t(x) for x in m_x], None if dec is None else t(dec),
                   seq_groups=S)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_joint_main_net_refuses_unported_options():
    """eval_capacity (ported since): the net builds and packs, its
    backbones running on cap rows at eval and on all rows in train mode
    (tests/test_torch_capacity.py holds it against JAX). fc2 fusion refuses
    decisions."""
    tmod = init_model(JointMainNet(("rgb", "sound"), depth=18,
                                   num_classes=5, eval_capacity=0.5))
    rows = []
    for m in ("rgb", "sound"):
        getattr(tmod, f"net_{m}").register_forward_hook(
            lambda mod, args, out: rows.append(args[0].shape[0]))
    x = [torch.randn(4, 2, 16, 16, 3), torch.randn(4, 1, 32, 16, 1)]
    dec = torch.tensor([[1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    with torch.no_grad():
        out = tmod(x, dec)
        assert rows == [2, 2] and tuple(out.shape) == (4, 5)
        tmod(x, dec, train=True, generator=torch.Generator())
    assert rows[2:] == [4, 4]
    tmod = JointMainNet(("rgb",), depth=18, fusion_point="fc2")
    with pytest.raises(ValueError, match="logits fusion"):
        tmod([torch.zeros(1, 1, 8, 8, 3)], torch.ones(1, 1))


def test_adamml_proxy_modalities(monkeypatch):
    """rgbdiff + flow: the policy reads rgbdiff, the main net flow (one main
    modality, so the learnable late-fusion weight vector is empty). The
    decision head is biased on, so the flow logits reach the output."""
    from adamml_tpu.models.adamml import AdaMML as JAdaMML
    from adamml_tpu_torch.models.adamml import AdaMML

    rs = np.random.RandomState(8)
    x = [rs.randn(2, S, 4, 32, 32, 15).astype(np.float32),
         rs.randn(2, S, 4, 32, 32, 10).astype(np.float32)]
    jx = [jnp.asarray(v) for v in x]
    kw = dict(modality=("rgbdiff", "flow"), num_classes=5, depth=18,
              learnable_lf_weights=True, causality_modeling="lstm",
              policy_input_size=24)
    jmod = JAdaMML(dtype=jnp.float32, **kw)
    v = flax_variables(jmod, rs, jx, train=False)
    v["params"]["policy_net"]["lstm"]["fc_0"]["bias"][:] = [0.0, 10.0]
    assert v["params"]["main_net"]["lf_weights"].shape == (0,)
    monkeypatch.setattr(jpolicy, "gumbel_decision", zero_noise_jax)
    want_logits, want_dec = jax.jit(lambda v, x: jmod.apply(
        v, x, 5.0, train=False, rngs={"gumbel": jax.random.PRNGKey(0)}))(
            v, jx)
    tmod = load_flax_variables(AdaMML(**kw), v["params"], v["batch_stats"])
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
    with torch.no_grad():
        logits, dec = tmod([t(a) for a in x], 5.0)
    assert tuple(dec.shape) == (2, S, 1) and bool((dec == 1).all())
    np.testing.assert_array_equal(dec.numpy(), np.asarray(want_dec))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
