"""The sm90 route of the port's SSD scan (K3) on the CPU: its plain version
against the JAX package's, the route rule, and what the sm90 launcher checks
before a launch.

The sm90 kernel (``csrc/ssd_scan_sm90.cu``) multiplies on the bf16 tensor
cores.  x, B and C are bf16 already; each product with an fp32 operand (the
mixing tile M, the state weights w·B and the carried state h_in) takes that
operand as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi).  Its plain
version, ``ssd_scan_torch(..., split=True)``, forms the same terms; here it
runs against the Pallas kernel in interpret mode and the time-recurrence
oracle ``ssd_scan_ref`` on the same numpy inputs rounded to bf16, as
tests/test_torch_ssd.py runs them.

Tolerance, derived: v - hi is exact in fp32 and at most 2**-8 |v|, and
rounding it to bf16 errs by at most 2**-8 of it, so hi + lo is v within
2**-16 |v|.  Each product then errs by at most 2**-16 of the sum of its
terms' magnitudes.  The carried state passes its own error on through
decays <= 1, and y sums two products (M·x, and C·h_in with h_in's error), so
y and the state err by at most 3·2**-16 < 2**-14 of ``y_abs`` (the same scan
on |x|, |B| and |C|, which bounds every such sum), on top of the reference's
own 2e-4 (tests/test_torch_ssd.py: the chunked and the step-by-step sums
differ in order).  A bf16 y adds one rounding of the output, 2**-8 |want|.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.models.ssm import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import split_bf16, ssd_scan_torch
from test_torch_ssd import CASES, _inputs, _oracle

SM90_CASES = [  # B, S, H, P, N, chunk: on the sm90 route when bf16
    (1, 256, 2, 64, 64, 128),   # two full chunks of zamba2-1.2b's size
    (1, 200, 2, 64, 64, 128),   # ragged at 128
    (2, 150, 2, 64, 64, 64),    # B 2, ragged at 64
    (1, 40, 3, 64, 64, 128),    # one chunk, shorter than 16 rows a tile x 3
]


def _bf16_inputs(B, S, H, P, N, seed):
    """_inputs with x, B and C rounded to bf16 (numpy, for the JAX side) and
    as torch tensors in fp32 and in bf16."""
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed)
    x, Bm, Cm = (v.astype(ml_dtypes.bfloat16).astype(np.float32) for v in (x, Bm, Cm))
    f32 = [torch.from_numpy(v) for v in (x, dt, Bm, Cm, a)]
    bf16 = [t.to(torch.bfloat16) if i in (0, 2, 3) else t for i, t in enumerate(f32)]
    return (x, dt, Bm, Cm, a), f32, bf16


def _want(x, dt, Bm, Cm, a, chunk):
    py, pstate = jax_ssd(*map(jnp.asarray, (x, dt, Bm, Cm, a)), chunk=chunk, interpret=True)
    ry, rstate = _oracle(x, dt, Bm, Cm, a)
    return [(np.asarray(py, np.float32), np.asarray(pstate, np.float32)), (ry, rstate)]


def _abs_scan(f32, chunk):
    """y_abs and state_abs: the scan on |x|, |B|, |C|."""
    x, dt, Bm, Cm, a = f32
    return ssd_scan_torch(x.abs(), dt, Bm.abs(), Cm.abs(), a, chunk)


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES + SM90_CASES)
def test_split_plain_matches_pallas_and_recurrence(B, S, H, P, N, chunk):
    npy, f32, _ = _bf16_inputs(B, S, H, P, N, seed=B * S + chunk + 1)
    y, state = ssd_scan_torch(*f32, chunk=chunk, split=True)
    y_abs, state_abs = _abs_scan(f32, chunk)
    for want_y, want_state in _want(*npy, chunk):
        assert (np.abs(y.numpy() - want_y) <= 2e-4 + 2.0 ** -14 * y_abs.numpy()).all()
        assert (np.abs(state.numpy() - want_state)
                <= 2e-4 + 2.0 ** -14 * state_abs.numpy()).all()


@pytest.mark.parametrize("B,S,H,P,N,chunk", SM90_CASES)
def test_wrapper_runs_the_sm90_plain_version_on_bf16(B, S, H, P, N, chunk):
    """bf16 with N = P = 64 takes the sm90 route; on CPU tensors ``ops.ssd``
    runs that route's plain version, bit for bit, and it holds against the
    JAX kernel with one bf16 rounding of y more."""
    npy, f32, bf16 = _bf16_inputs(B, S, H, P, N, seed=S + H + chunk)
    assert ops.route(bf16[0], bf16[2]) == "sm90"
    y, state = ops.ssd(*bf16, chunk=chunk)
    want_y, want_state = ssd_scan_torch(*bf16, chunk=chunk, split=True)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y_abs, state_abs = _abs_scan(f32, chunk)
    for ref_y, ref_state in _want(*npy, chunk):
        tol = 2e-4 + 2.0 ** -14 * y_abs.numpy() + 2.0 ** -8 * np.abs(ref_y)
        assert (np.abs(y.float().numpy() - ref_y) <= tol).all()
        assert (np.abs(state.numpy() - ref_state)
                <= 2e-4 + 2.0 ** -14 * state_abs.numpy()).all()


def _scan_before_split(x, dt, Bm, Cm, a, chunk):
    """ssd_scan_torch as it was before ``split`` (fp32 decay), copied: the
    reference for bit-for-bit equality of ``split=False``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(Bsz, nc, Q, H, P)
    Bc, Cc = Bf.reshape(Bsz, nc, Q, N), Cf.reshape(Bsz, nc, Q, N)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    L = torch.cumsum(dtc * a.to(f32), dim=2)
    Llast = L[:, :, -1]
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    xdt = xc * dtc[..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", G, decay, xdt)
    w = torch.exp(Llast[:, :, None, :] - L) * dtc
    cs = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, xc)
    dec = torch.exp(Llast)
    h = torch.zeros(Bsz, H, N, P, dtype=f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = dec[:, c, :, None, None] * h + cs[:, c]
    h_in = torch.stack(h_in, dim=1)
    y = y + torch.einsum("bcin,bchnp,bcih->bcihp", Cc, h_in, torch.exp(L))
    return y.reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype), h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_off_is_unchanged(dtype):
    """split=False (the default, the scalar route's plain version) is the
    scan as it was, bit for bit; the split is not a no-op, and in fp32 it
    moves y and the state by at most 2**-14 of y_abs and state_abs."""
    _, f32, bf16 = _bf16_inputs(2, 300, 3, 64, 64, seed=5)
    inputs = f32 if dtype == torch.float32 else bf16
    for chunk in (64, 128):
        base = ssd_scan_torch(*inputs, chunk=chunk)
        before = _scan_before_split(*inputs, chunk)
        assert all(torch.equal(u, v) for u, v in zip(base, before))
        assert all(torch.equal(u, v) for u, v in
                   zip(ssd_scan_torch(*inputs, chunk=chunk, split=False), base))
    y, state = ssd_scan_torch(*f32, chunk=128)
    sy, sstate = ssd_scan_torch(*f32, chunk=128, split=True)
    assert not torch.equal(y, sy)
    y_abs, state_abs = _abs_scan(f32, 128)
    assert ((sy - y).abs() <= 2.0 ** -14 * y_abs).all()
    assert ((sstate - state).abs() <= 2.0 ** -14 * state_abs).all()
    # fp32 inputs take the scalar route, whose plain version is the default
    assert ops.route(f32[0], f32[2]) == "scalar"
    assert all(torch.equal(u, v) for u, v in zip(ops.ssd(*f32, chunk=128), (y, state)))


def test_split_bf16_bound():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    v = v * torch.exp(torch.linspace(-30, 30, 10_000))
    hi, lo = split_bf16(v)
    assert torch.equal(hi, v.to(torch.bfloat16).float())
    assert ((hi + lo - v).abs() <= 2.0 ** -16 * v.abs()).all()


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES + SM90_CASES)
def test_split_bf16_decay_matches_reference(B, S, H, P, N, chunk):
    """The sm90 route's plain form with a bf16 decay against the reference's
    ``_ssd_chunked(decay_dtype=bf16)`` on the same bf16-rounded inputs, and
    against the unsplit bf16-decay form.  M = bf16(G)·bf16(exp) is exact in
    its two bf16 terms, so split and unsplit differ in the order of their
    fp32 sums alone (2**-14 of ``y_abs``, as above).  Against the
    reference, tests/test_torch_ssd.py's bf16-decay tolerance (5e-2 on y,
    2e-4 on the state, which stays fp32): both round L, its differences,
    the exp, G and x·dt to bf16, in sums of another order.  At chunk 128
    the reference's exp above the diagonal overflows and its y is NaN
    there (ref.py's docstring); the port stays finite and is held wherever
    the reference is finite."""
    npy, f32, bf16 = _bf16_inputs(B, S, H, P, N, seed=B * S + chunk + 5)
    x, dt, Bm, Cm, a = npy
    jy, jstate = jax_ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, a)), chunk=chunk,
                                 decay_dtype=jnp.bfloat16)
    y, state = ssd_scan_torch(*f32, chunk=chunk, split=True, decay_dtype=torch.bfloat16)
    uy, ustate = ssd_scan_torch(*f32, chunk=chunk, decay_dtype=torch.bfloat16)
    y_abs, state_abs = _abs_scan(f32, chunk)
    assert ((y - uy).abs() <= 2.0 ** -14 * y_abs).all()
    assert ((state - ustate).abs() <= 2.0 ** -14 * state_abs).all()
    jy, jstate = np.asarray(jy, np.float32), np.asarray(jstate, np.float32)
    finite = np.isfinite(jy)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    assert finite.mean() > 0.1
    assert np.abs(y.numpy() - jy)[finite].max() <= 5e-2
    assert np.abs(state.numpy() - jstate).max() <= 2e-4
    # bf16 inputs at N = P = 64 take this form through the wrapper
    if ops.route(bf16[0], bf16[2]) == "sm90":
        got = ops.ssd(*bf16, chunk=chunk, decay_dtype=torch.bfloat16)
        want = ssd_scan_torch(*bf16, chunk=chunk, split=True, decay_dtype=torch.bfloat16)
        assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 64, "sm90"),
    (torch.float32, 64, 64, "scalar"),
    (torch.bfloat16, 32, 32, "scalar"),
    (torch.bfloat16, 128, 128, "scalar"),
    (torch.bfloat16, 64, 16, "scalar"),     # N != P
    (torch.bfloat16, 64, 128, "sm90"),      # Nemotron-H's N
    (torch.bfloat16, 16, 64, "scalar"),
    (torch.float32, 8, 4, "scalar"),
])
@pytest.mark.parametrize("S", [1, 100, 1024])
def test_route_rule(dtype, P, N, want, S):
    x = torch.zeros(1, S, 2, P, dtype=dtype)
    Bm = torch.zeros(1, S, N, dtype=dtype)
    assert ops.route(x, Bm) == want
    assert ops.PLAIN_ARGS[want] == ({"split": True} if want == "sm90" else {})


def test_copy_check():
    B, S, H = 2, 16, 4
    x = torch.zeros(B, S, H, 64, dtype=torch.bfloat16)
    Bm = torch.zeros(B, S, 64, dtype=torch.bfloat16)
    ops.copy_check(x, Bm, Bm)
    # every other head of a wider tensor, as chip_smoke.py feeds it: strides
    # of 128 elements
    ops.copy_check(torch.zeros(B, S, 2 * H, 64, dtype=torch.bfloat16)[:, :, ::2], Bm, Bm)
    # a dim of size 1 may carry any stride: it is never stepped
    ops.copy_check(x[:1], Bm[:1].transpose(0, 1).transpose(0, 1), Bm[:1])
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ops.copy_check(flat[1:].view(x.shape), Bm, Bm)
    with pytest.raises(ValueError, match="stride"):
        ops.copy_check(x, torch.zeros(B, S, 65, dtype=torch.bfloat16)[..., :64], Bm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.copy_check(torch.zeros(B, S, H, 128, dtype=torch.bfloat16)[..., ::2], Bm, Bm)


def test_launchers_take_only_cuda():
    _, _, bf16 = _bf16_inputs(1, 16, 2, 64, 64, seed=0)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_sm90(*bf16)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scalar(*bf16)
