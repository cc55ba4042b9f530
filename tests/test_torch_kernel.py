"""PyTorch port: the fused stage-boundary epilogue's plain forward and
backward and its wrapper against the JAX package's Pallas kernels.

On the CPU the JAX kernels run in Pallas interpret mode, as
tests/test_pallas.py runs them; the port's plain versions run in float32.
The CUDA kernels themselves are compared with the plain versions only on a
card, in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adamml_tpu.ops.pallas import tpool_fused as jtp
from adamml_tpu_torch.ops.kernels import build
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp

from torch_parity import one_torch_thread, t  # noqa: F401


def _args(rs, n, f, h, w, c, r, s, dtype=np.float32):
    y = rs.randn(n, f, h, w, c).astype(dtype)
    ident = rs.randn(n, f, h, w, c).astype(dtype)
    a = (rs.randn(r, s, c) * 0.3 + 1.0).astype(np.float32)
    b = (rs.randn(r, s, c) * 0.1).astype(np.float32)
    return y, ident, a, b


# (R, S) x F; N is a multiple of R*S with N*F % 8 == 0 (the HWNFC
# variant's byte-identity condition), C = 128 (its lane condition)
_RS_N = {(1, 1): 8, (2, 2): 8, (1, 3): 24}
CASES = [(rs_, f) for rs_ in _RS_N for f in (2, 3, 4, 8)]


@pytest.mark.parametrize("rs_,f", CASES, ids=[f"R{r}S{s}-F{f}"
                                              for (r, s), f in CASES])
def test_reference_impl_matches_pallas(rs_, f):
    """Port plain version == JAX reference_impl == _pallas_fwd ==
    _pallas_fwd_hwnfc (interpret mode), f32, within 1e-6 (one f32 rounding
    of a possibly contracted multiply-add)."""
    r, s = rs_
    y, ident, a, b = _args(np.random.RandomState(f * 10 + r + s), _RS_N[rs_],
                           f, 4, 4, 128, r, s)
    got = ttp.reference_impl(t(y), t(ident), t(a), t(b)).numpy()
    assert got.shape == (_RS_N[rs_], (f - 1) // 2 + 1, 4, 4, 128)
    jargs = [jnp.asarray(v) for v in (y, ident, a, b)]
    for name, want in (
            ("reference_impl", jtp.reference_impl(*jargs)),
            ("_pallas_fwd", jtp._pallas_fwd(*jargs, interpret=True)),
            ("_pallas_fwd_hwnfc", jtp._pallas_fwd_hwnfc(*jargs,
                                                        interpret=True))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_reference_impl_bf16_matches_jax():
    """bf16 I/O: f32 math, one rounding at the end -- at most one bf16 ulp
    apart (a contracted multiply-add can move the rounding)."""
    y, ident, a, b = _args(np.random.RandomState(7), 6, 5, 3, 3, 16, 2, 3)
    yb = t(y).to(torch.bfloat16)
    ib = t(ident).to(torch.bfloat16)
    got = ttp.reference_impl(yb, ib, t(a), t(b))
    assert got.dtype == torch.bfloat16
    want = jtp.reference_impl(
        jnp.asarray(yb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(ib.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(a), jnp.asarray(b))
    got32 = got.float().numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    ulp = np.where(want32 == 0, 0.0,
                   2.0 ** (np.floor(np.log2(np.abs(want32) + 1e-30)) - 7))
    assert np.all(np.abs(got32 - want32) <= ulp)


def _ct(rs, y):
    n, f, h, w, c = y.shape
    return rs.randn(n, (f - 1) // 2 + 1, h, w, c).astype(np.float32)


def _jax_bwds(y, ident, a, b, ct):
    """(name, (dy, dident, da, db)) of jax.vjp of the JAX reference_impl and
    of both backward Pallas kernels (interpret mode) with _pallas_bwd's
    post-processing (tpool_fused.py:195-203) written out: on the 8-device
    CPU mesh _pallas_bwd itself would take the GSPMD path."""
    jargs = [jnp.asarray(v) for v in (y, ident, a, b)]
    jct = jnp.asarray(ct)
    _, vjp = jax.vjp(jtp.reference_impl, *jargs)
    r, s, c = a.shape
    n = y.shape[0]

    def post(dpre, dab):
        bshape = (r, 1, s, 1, 1, 1, c)
        dy = (dpre.astype(jnp.float32).reshape((r, n // (r * s), s)
                                               + y.shape[1:])
              * jargs[2].reshape(bshape)).reshape(y.shape)
        part = dab.reshape(r, n // (r * s), s, 2, c).sum(axis=1)
        return dy, dpre, part[:, :, 0], part[:, :, 1]

    return [("jax.vjp(reference_impl)", vjp(jct)),
            ("_bwd_core", post(*jtp._bwd_core(*jargs, jct, interpret=True))),
            ("_bwd_hwnfc", post(*jtp._bwd_hwnfc(*jargs, jct,
                                                 interpret=True)))]


@pytest.mark.parametrize("rs_,f", CASES, ids=[f"R{r}S{s}-F{f}"
                                              for (r, s), f in CASES])
def test_reference_bwd_matches_jax(rs_, f):
    """Port plain backward == jax.vjp(reference_impl) == _bwd_core ==
    _bwd_hwnfc (interpret mode), f32: dy and dident within 1e-6; da and db
    within 1e-5 (sums over F*H*W*N/(R*S) terms in another order)."""
    r, s = rs_
    rs = np.random.RandomState(f * 10 + r + s + 1)
    y, ident, a, b = _args(rs, _RS_N[rs_], f, 4, 4, 128, r, s)
    ct = _ct(rs, y)
    got = ttp.reference_bwd(*(t(v) for v in (y, ident, a, b, ct)))
    for name, want in _jax_bwds(y, ident, a, b, ct):
        for g, w, what in zip(got, want, ("dy", "dident", "da", "db")):
            assert tuple(g.shape) == w.shape, (name, what)
            tol = 1e-6 if what in ("dy", "dident") else 1e-5
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol, err_msg=f"{name} {what}")


# the 'model' channel block of tests/test_tpool_sharded.py's
# test_2d_mesh_batch_and_channel_shard_local: block m of M over C = 256
# (C / M = 128 or 64, multiples of 8); (M, m, R, S, F)
BLOCK_CASES = [(2, 0, 1, 1, 4), (2, 1, 2, 2, 3), (4, 2, 1, 3, 8)]
BLOCK_IDS = [f"M{c[0]}m{c[1]}-R{c[2]}S{c[3]}-F{c[4]}" for c in BLOCK_CASES]


def _block_args(msize, m, r, s, f, seed):
    rs = np.random.RandomState(seed)
    full = _args(rs, _RS_N[(r, s)], f, 4, 4, 256, r, s)
    cb = 256 // msize
    lo, hi = m * cb, (m + 1) * cb
    block = [np.ascontiguousarray(v[..., lo:hi]) for v in full]
    return rs, full, block, (lo, hi)


@pytest.mark.parametrize("msize,m,r,s,f", BLOCK_CASES, ids=BLOCK_IDS)
def test_reference_impl_on_a_channel_block(msize, m, r, s, f):
    """The plain forward on channels [m C / M, (m + 1) C / M) with the
    affine's matching slice is that block of the full-C result, bit for
    bit (no channel reads another); and the Pallas kernels (interpret
    mode) on the same block agree within 1e-6, as on full C."""
    _, full, block, (lo, hi) = _block_args(msize, m, r, s, f, 40 + m)
    got = ttp.reference_impl(*(t(v) for v in block))
    whole = ttp.reference_impl(*(t(v) for v in full))
    assert torch.equal(got, whole[..., lo:hi].contiguous())
    jargs = [jnp.asarray(v) for v in block]
    for name, want in (
            ("_pallas_fwd", jtp._pallas_fwd(*jargs, interpret=True)),
            ("_pallas_fwd_hwnfc", jtp._pallas_fwd_hwnfc(*jargs,
                                                        interpret=True))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("msize,m,r,s,f", BLOCK_CASES, ids=BLOCK_IDS)
def test_reference_bwd_on_a_channel_block(msize, m, r, s, f):
    """The plain backward on a channel block (the cotangent's block too):
    dy, dident, da and db are those blocks of the full-C backward, bit for
    bit; against the Pallas backward kernels (interpret mode) on the same
    block with test_reference_bwd_matches_jax's tolerances."""
    rs, full, block, (lo, hi) = _block_args(msize, m, r, s, f, 50 + m)
    ct = _ct(rs, full[0])
    cblock = np.ascontiguousarray(ct[..., lo:hi])
    got = ttp.reference_bwd(*(t(v) for v in [*block, cblock]))
    whole = ttp.reference_bwd(*(t(v) for v in [*full, ct]))
    for g, w, what in zip(got, whole, ("dy", "dident", "da", "db")):
        assert torch.equal(g, w[..., lo:hi].contiguous()), what
    for name, want in _jax_bwds(*block, cblock)[1:]:
        for g, w, what in zip(got, want, ("dy", "dident", "da", "db")):
            tol = 1e-6 if what in ("dy", "dident") else 1e-5
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol, err_msg=f"{name} {what}")


def test_reference_bwd_routes_ties_to_first_max():
    """All frames equal (tests/test_pallas.py:171-191): each window's
    cotangent goes to its first frame, as every JAX backward does."""
    rs = np.random.RandomState(0)
    n, f, h, w, c = 8, 4, 4, 4, 128
    frame = np.abs(rs.randn(n, 1, h, w, c)) + 0.5
    y = np.tile(frame, (1, f, 1, 1, 1)).astype(np.float32)
    ident = np.zeros_like(y)
    a = np.ones((1, 1, c), np.float32)
    b = np.zeros((1, 1, c), np.float32)
    ct = _ct(rs, y)
    got = ttp.reference_bwd(*(t(v) for v in (y, ident, a, b, ct)))
    np.testing.assert_array_equal(got[1].numpy()[:, :2], ct)
    assert not got[1].numpy()[:, 2:].any()
    for name, want in _jax_bwds(y, ident, a, b, ct):
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_autograd_on_cpu_takes_plain_backward():
    """fused_bn_add_relu_tpool's gradients on CPU tensors are
    reference_bwd's, bit for bit, and launch nothing; bf16 gradients come
    back in their operands' dtypes."""
    rs = np.random.RandomState(5)
    y, ident, a, b = _args(rs, 6, 5, 3, 3, 16, 2, 3)
    ct = _ct(rs, y)
    before = dict(ttp.launch_counts)
    for dtype in (torch.float32, torch.bfloat16):
        ops = [t(y).to(dtype), t(ident).to(dtype), t(a), t(b)]
        leaves = [v.requires_grad_(True) for v in ops]
        out = ttp.fused_bn_add_relu_tpool(*leaves)
        out.backward(t(ct).to(dtype))
        want = ttp.reference_bwd(*(v.detach() for v in leaves),
                                 t(ct).to(dtype))
        for leaf, w in zip(leaves, want):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, w)
    assert ttp.launch_counts == before


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    y, ident, a, b = _args(np.random.RandomState(3), 4, 4, 2, 2, 8, 1, 2)
    before = dict(ttp.launch_counts)
    out = ttp.fused_bn_add_relu_tpool(t(y), t(ident), t(a), t(b))
    np.testing.assert_array_equal(
        out.numpy(), ttp.reference_impl(t(y), t(ident), t(a), t(b)).numpy())
    assert ttp.launch_counts == before


@pytest.mark.parametrize("bad", [
    "f1", "c_not_8", "rows", "segments", "dtype", "affine_dtype",
    "mismatch", "noncontig", "misaligned", "ct_shape", "ct_dtype",
    "ct_noncontig"])
def test_check_args_rejects(bad):
    """What the CUDA path refuses, checked in Python before any launch."""
    rs = np.random.RandomState(0)
    n, f, h, w, c, r, s = 4, 4, 2, 2, 16, 1, 2
    if bad == "f1":
        f = 1
    if bad == "c_not_8":
        c = 12
    if bad == "rows":
        n = 3
    if bad == "segments":
        n, r, s = 4, 2, 4
    y, ident, a, b = (t(v) for v in _args(rs, n, f, h, w, c, r, s))
    if bad == "dtype":
        y, ident = y.double(), ident.double()
    if bad == "affine_dtype":
        a = a.to(torch.bfloat16)
    if bad == "mismatch":
        ident = ident.to(torch.bfloat16)
    if bad == "noncontig":
        y = y.transpose(2, 3)
    if bad == "misaligned":
        y = torch.empty(y.numel() + 1)[1:].view(y.shape)
    ct = t(_ct(rs, y.detach().numpy())) if bad.startswith("ct") else None
    if bad == "ct_shape":
        ct = ct[:, :1].contiguous()
    if bad == "ct_dtype":
        ct = ct.to(torch.bfloat16)
    if bad == "ct_noncontig":
        ct = ct.transpose(2, 3)
    with pytest.raises(ValueError):
        ttp.check_args(y, ident, a, b, ct)
    # the good arguments pass
    ttp.check_args(*(t(v) for v in _args(rs, 4, 4, 2, 2, 16, 1, 2)))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["tpool_fused", "tpool_fused_bwd"])
    assert list(tmp_path.iterdir()) == []


def test_library_name_follows_source(monkeypatch, tmp_path):
    """An edited source gets a new library file, so a stale build is never
    loaded."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    src.write_text("// two")
    assert build.library_path("k") != first
    assert first.parent == build.BUILD_DIR
