"""The port's SSD scan (K3's plain version and its wrapper) against the JAX
package's.

The same numpy inputs go through the Pallas kernel in interpret mode and
the time-recurrence oracle ``ssd_scan_ref`` (as tests/test_ssd_kernel.py
runs them) and through the port.  Tolerances are that file's: atol 2e-4 in
fp32 (the chunked and the step-by-step sums differ in order) and 5e-2 with
bf16 inputs (one bf16 rounding of outputs of size O(1)).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_scan_ref
from repro.models.ssm import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_scan_recurrence, ssd_scan_torch
from repro_torch.models.ssm import _ssd_chunked

CASES = [  # B, S, H, P, N, chunk: tests/test_ssd_kernel.py's four, then B>1 with H>1
    (1, 32, 2, 8, 4, 8),
    (2, 64, 2, 16, 8, 16),
    (1, 48, 4, 8, 8, 16),   # ragged: S not a chunk multiple
    (2, 16, 1, 8, 4, 16),   # single chunk
    (2, 40, 3, 8, 4, 16),   # B=2, H=3: B and C shared across heads, ragged
]


def _inputs(B, S, H, P, N, seed, a_value=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    a = (np.full(H, a_value) if a_value is not None else
         -np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    return x, dt, Bm, Cm, a


def _oracle(x, dt, Bm, Cm, a):
    """ssd_scan_ref on the folded per-head layout, back in the model layout."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    dtf = jnp.asarray(dt).transpose(0, 2, 1).reshape(B * H, S)
    Bf = jnp.repeat(jnp.asarray(Bm)[:, None], H, 1).reshape(B * H, S, N)
    Cf = jnp.repeat(jnp.asarray(Cm)[:, None], H, 1).reshape(B * H, S, N)
    y, h = ssd_scan_ref(xf, dtf, Bf, Cf, jnp.tile(jnp.asarray(a), B))
    return (np.asarray(y.astype(jnp.float32)).reshape(B, H, S, P).transpose(0, 2, 1, 3),
            np.asarray(h).reshape(B, H, N, P))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("impl", ["ssd_scan_torch", "ops.ssd"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssd_matches_pallas_and_recurrence(impl, B, S, H, P, N, chunk):
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed=B * S + chunk)
    fn = ssd_scan_torch if impl == "ssd_scan_torch" else ops.ssd
    y, state = fn(*_t(x, dt, Bm, Cm, a), chunk=chunk)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, N, P)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    py, pstate = jax_ssd(*map(jnp.asarray, (x, dt, Bm, Cm, a)), chunk=chunk, interpret=True)
    ry, rstate = _oracle(x, dt, Bm, Cm, a)
    for want_y, want_state in ((py, pstate), (ry, rstate)):
        assert _err(y, want_y) <= 2e-4
        assert _err(state, want_state) <= 2e-4


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssd_recurrence_matches_reference(B, S, H, P, N, chunk):
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed=S + H + chunk)
    y, state = ssd_scan_recurrence(*_t(x, dt, Bm, Cm, a))
    ry, rstate = _oracle(x, dt, Bm, Cm, a)
    assert _err(y, ry) <= 2e-4 and _err(state, rstate) <= 2e-4


def test_ssd_bf16_inputs():
    B, S, H, P, N = 1, 32, 2, 8, 4
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed=3)
    x, Bm, Cm = (v.astype(ml_dtypes.bfloat16) for v in (x, Bm, Cm))
    tx, tB, tC = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                  for v in (x, Bm, Cm))
    y, _ = ops.ssd(tx, torch.from_numpy(dt), tB, tC, torch.from_numpy(a), chunk=16)
    assert y.dtype == torch.bfloat16
    py, _ = jax_ssd(*map(jnp.asarray, (x, dt, Bm, Cm, a)), chunk=16, interpret=True)
    ry, _ = _oracle(x, dt, Bm, Cm, a)
    assert _err(y, py) <= 5e-2 and _err(y, ry) <= 5e-2


def test_chunk_where_the_reference_overflows():
    """chunk 128, a = -1 (what a_log = 0 gives), dt = softplus(N(0,1)): a
    chunk's summed a·dt passes -88, so exp(L_i - L_j) above the diagonal is
    inf in fp32.  The reference's ``_ssd_chunked`` multiplies it by the
    mask (inf·0 = NaN); the port masks before the exp and stays finite and
    equal to the recurrence."""
    B, S, H, P, N = 1, 256, 2, 8, 4
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed=11, a_value=-1.0)
    assert float(dt[0, :128].sum(0).min()) > 88
    ry, rstate = _oracle(x, dt, Bm, Cm, a)
    assert np.isfinite(ry).all()
    jy, _ = jax_ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, a)), chunk=128)
    assert np.isnan(np.asarray(jy)).any()
    tx, tdt, tB, tC, ta = _t(x, dt, Bm, Cm, a)
    for y, state in (_ssd_chunked(tx, tB, tC, tdt, ta, 128),
                     ssd_scan_torch(tx, tdt, tB, tC, ta, chunk=128)):
        assert torch.isfinite(y).all() and torch.isfinite(state).all()
        assert _err(y, ry) <= 2e-4 and _err(state, rstate) <= 2e-4


@pytest.mark.parametrize("entry", ["_ssd_chunked", "ops.ssd"])
def test_ssd_chunked_decay_dtype_matches_reference(entry):
    """The bf16 decay lever of the reference's CPU path, through the port's
    chunked path and through the wrapper the model calls: the decay tile and
    the intra-chunk operands in bf16, accumulated in fp32 (atol 5e-2: bf16
    rounding of values of size O(1))."""
    B, S, H, P, N = 2, 32, 2, 8, 4
    x, dt, Bm, Cm, a = _inputs(B, S, H, P, N, seed=9)
    jy, jstate = jax_ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, a)), chunk=8,
                                 decay_dtype=jnp.bfloat16)
    tx, tdt, tB, tC, ta = _t(x, dt, Bm, Cm, a)
    if entry == "ops.ssd":
        y, state = ops.ssd(tx, tdt, tB, tC, ta, 8, decay_dtype=torch.bfloat16)
    else:
        y, state = _ssd_chunked(tx, tB, tC, tdt, ta, 8, decay_dtype=torch.bfloat16)
    assert _err(y, jy) <= 5e-2 and _err(state, jstate) <= 2e-4


def test_ssd_wrapper_checks_its_inputs():
    x, dt, Bm, Cm, a = _t(*_inputs(1, 16, 2, 8, 4, seed=0))
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd(x, dt, Bm.double(), Cm, a)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd(x, dt.double(), Bm, Cm, a)
    with pytest.raises(ValueError, match="agree"):
        ops.ssd(x, dt[:, :8], Bm, Cm, a)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd(*(t.to("meta") for t in (x, dt, Bm, Cm, a)))
