"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode.  This file imports neither jax nor the JAX
package, so it also runs on a machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1 counts integers (exact), through the tensor API
(``ops.event_join``) and through the join backend (``dispatch.CudaJoin``).
K2 has two routes, each held against its own plain version (the sm90 one
splits p into two bf16 terms for P·V over kv tiles of 128, as the kernel
does).  Kernel and plain version
both compute in fp32 and differ only in the summation order (and in the
rounding of p's second term, within 2**-16 max|v|), so in bf16 an output
differs by at most one rounding flip, |got - want| <= 2**-7 |want| + 1e-3
(one bf16 ulp, with a floor for outputs near 0); in fp32 by at most 1e-4
(summation order over up to 1024 keys).  K3 has two routes, each held
against its own plain version (the sm90 one splits each fp32 operand of its
tensor-core products into two bf16 terms, as the kernel does).  Kernel and
plain version compute in fp32 in another order (the chunk's cumsum of a·dt
included), so the state and fp32 outputs differ by at most
1e-4·(1 + max|want|), and bf16 outputs by one rounding flip more,
2**-7 |want|.  The decode step's kernel (``ssd_step``) rounds each new state
element as its plain version does, so the state agrees within a few fp32
ulps; its y is held as K3's bf16 outputs are.  The model families of the vlm, audio, moe and mla_moe kinds
prefill on the card against the same weights on the CPU, at smoke size in
fp32: their attention takes K2's scalar route on the card and the chunked
plain path on the CPU, so logits and cache agree within 1e-4·(1 + max|cpu|).
deepseek-v2 also prefills in bf16 at smoke depth with its published head
dims (D 192 = nope 128 + rope 64, Dv 128): every layer takes K2's sm90
route, and its output is held to the sm90 plain version on that layer's own
inputs at the bf16 tolerance above.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.event_join import dispatch as join_dispatch
from repro_torch.kernels.event_join import ops as join_ops
from repro_torch.kernels.event_join.ref import join_counts_torch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_torch
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_scan_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# K1's paths: one block with shared bins (n <= 4096 events), many blocks
# with shared bins up to 49 152 bins, and global bins past them (one block
# or many)
@pytest.mark.parametrize("T,N", [(100, 0), (100, 5), (100, 4096), (100, 200_000),
                                 (4096, 1_048_576), (60_000, 100_000),
                                 (1, 50), (1, 100_000), (100, 4097), (100, 8193),
                                 (100, 65_536), (49_152, 300_000), (49_152, 2000),
                                 (49_153, 1000), (60_000, 7)])
def test_event_join_kernel_matches_plain(cuda, T, N):
    rng = np.random.default_rng(N)
    events = torch.from_numpy(rng.integers(-1, T + 3, N).astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, 5, T).astype(np.int32))
    expected = torch.from_numpy(rng.integers(1, 30, T).astype(np.int32))
    nc, fired = join_ops.event_join(events.to(cuda), counts.to(cuda), expected.to(cuda))
    want_nc, want_f = join_counts_torch(events, counts, expected)
    assert torch.equal(nc.cpu(), want_nc) and torch.equal(fired.cpu(), want_f)


@pytest.mark.parametrize("kind,N", [("runs", 4096), ("runs", 200_000), ("padding", 5000),
                                    ("padding", 50_000)])
def test_event_join_kernel_on_runs_and_padding(cuda, kind, N):
    """The worker's batches (contiguous runs of one row id, which the warp
    vote folds into one atomic a run) and batches of padding alone."""
    T = 100
    if kind == "runs":
        events = torch.arange(T, dtype=torch.int32).repeat_interleave(N // T)
    else:
        events = torch.full((N,), -1, dtype=torch.int32)
    counts = torch.arange(T, dtype=torch.int32)
    expected = torch.full((T,), N // T, dtype=torch.int32)
    nc, fired = join_ops.event_join(events.to(cuda), counts.to(cuda), expected.to(cuda))
    want_nc, want_f = join_counts_torch(events, counts, expected)
    assert torch.equal(nc.cpu(), want_nc) and torch.equal(fired.cpu(), want_f)


def _join_case(rng, n, T):
    return (rng.integers(-1, T + 3, n).astype(np.int32),
            rng.integers(0, 5, T).astype(np.int32), rng.integers(1, 30, T).astype(np.int32))


def test_cuda_join_across_calls(cuda):
    """The join backend over calls of growing n and changing T, through every
    path of the kernel: exact against the plain backend, its scratch zero
    after every call, and each call's arrays unchanged by the calls after."""
    join = join_dispatch.CudaJoin(torch.device("cuda", torch.cuda.current_device()))
    rng = np.random.default_rng(5)
    kept = []
    launches = join_ops.launches
    shapes = [(0, 3), (10, 100), (4096, 100), (9000, 100), (200_000, 100), (5, 1),
              (300_000, 4096), (1000, 60_000), (100_000, 60_000), (4096, 100)]
    for n, T in shapes:
        events, counts, expected = _join_case(rng, n, T)
        nc, fired = join(events, counts, expected)
        want_nc, want_f = join_dispatch._torch_join(events, counts, expected)
        assert nc.dtype == fired.dtype == np.int32
        np.testing.assert_array_equal(nc, want_nc)
        np.testing.assert_array_equal(fired, want_f)
        assert join._scratch.count_nonzero().item() == 0
        kept.append((nc, fired, want_nc, want_f))
    assert join_ops.launches == launches + len(shapes)
    for nc, fired, want_nc, want_f in kept:
        np.testing.assert_array_equal(nc, want_nc)
        np.testing.assert_array_equal(fired, want_f)


def test_cuda_join_shared_between_threads(cuda):
    """One backend called from more threads than the host has cores, each
    with inputs of its own and a short switch interval: every result exact,
    which a lost update of the shared buffers would break."""
    join = join_dispatch.CudaJoin(torch.device("cuda", torch.cuda.current_device()))
    n_threads = 2 * (os.cpu_count() or 4)
    cases = [_join_case(np.random.default_rng(100 + i), 500 + 300 * i, 7 + i)
             for i in range(n_threads)]
    wants = [join_dispatch._torch_join(*case) for case in cases]
    bad = []

    def work(i):
        for _ in range(40):
            got = join(*cases[i])
            if not all(np.array_equal(g, w) for g, w in zip(got, wants[i])):
                bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_cuda_join_does_not_wait_for_other_streams(cuda):
    """A join call returns while PyTorch's current stream on the same card is
    still busy: the backend copies, launches and synchronises on a stream of
    its own."""
    join = join_dispatch.CudaJoin(torch.device("cuda", torch.cuda.current_device()))
    events, counts, expected = _join_case(np.random.default_rng(6), 4096, 100)
    join(events, counts, expected)  # makes the stream and the buffers
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of spinning on the current stream
    nc, fired = join(events, counts, expected)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy
    want_nc, want_f = join_dispatch._torch_join(events, counts, expected)
    np.testing.assert_array_equal(nc, want_nc)
    np.testing.assert_array_equal(fired, want_f)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,dtype,causal", [
    (1, 64, 4, 4, 16, 16, torch.float32, True),
    (2, 96, 4, 1, 16, 16, torch.float32, True),
    (1, 80, 4, 2, 16, 16, torch.float32, True),
    (1, 64, 4, 4, 16, 16, torch.float32, False),
    (1, 96, 4, 2, 32, 16, torch.float32, True),
    (2, 1000, 24, 8, 128, 128, torch.bfloat16, True),
    (1, 300, 4, 2, 256, 256, torch.float32, True),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, Dv, dtype, causal):
    """The scalar kernel, called by its own launcher (the bf16 D 128 case
    takes the sm90 route through flash_attention)."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    got = fa_ops.flash_attention_scalar(q, k, v, causal=causal)
    want = flash_attention_torch(q, k, v, causal=causal)
    want = want.float()
    tol = 2.0 ** -7 * want.abs() + 1e-3 if dtype == torch.bfloat16 else 1e-4
    assert ((got.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,causal", [
    (2, 64, 24, 8, 128, 128, True),     # llama3.2-3b's heads, S below, at, past one tile
    (2, 128, 24, 8, 128, 128, True),
    (2, 1000, 24, 8, 128, 128, True),
    (2, 1024, 24, 8, 128, 128, True),
    (2, 64, 32, 32, 64, 64, True),      # zamba2-1.2b's heads
    (2, 128, 32, 32, 64, 64, True),
    (2, 1000, 32, 32, 64, 64, True),
    (2, 1024, 32, 32, 64, 64, True),
    (2, 512, 16, 16, 128, 128, True),   # MHA
    (2, 512, 16, 1, 128, 128, True),    # MQA
    (2, 512, 24, 8, 128, 128, False),   # non-causal
    (2, 1000, 32, 32, 64, 64, False),   # non-causal, ragged
    (1, 40, 4, 2, 64, 64, True),        # B 1, S below one tile
    (2, 64, 16, 16, 192, 128, True),    # deepseek-v2's MLA prefill: S below,
    (2, 128, 16, 16, 192, 128, True),   # at and past one tile
    (2, 1000, 16, 16, 192, 128, True),
    (2, 1024, 128, 128, 192, 128, True),
    (2, 1000, 16, 16, 192, 128, False),  # non-causal, ragged
    (2, 512, 16, 4, 192, 128, True),    # GQA at D 192
    (1, 40, 4, 2, 192, 128, True),      # B 1, S below one tile
])
def test_flash_attention_sm90_matches_plain(cuda, B, S, Hq, Hkv, D, Dv, causal):
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    assert fa_ops.route(q, k, v) == "sm90"
    sm90, scalar = fa_ops.launches_sm90, fa_ops.launches_scalar
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert (fa_ops.launches_sm90, fa_ops.launches_scalar) == (sm90 + 1, scalar)
    want = fa_ops.flash_attention_plain(q, k, v, causal=causal).float()
    assert torch.isfinite(got).all() and got.shape == (B, S, Hq, Dv)
    assert ((got.float() - want).abs() <= 2.0 ** -7 * want.abs() + 1e-3).all()


def test_flash_attention_sm90_reads_strided_views(cuda):
    """q, k and v as head slices of one fused [B,S,Hq+2Hkv,D] tensor: the
    tensor maps take their strides, nothing is copied."""
    B, S, Hq, Hkv, D = 2, 300, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ops.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous()).float()
    assert ((got.float() - want).abs() <= 2.0 ** -7 * want.abs() + 1e-3).all()


def test_flash_attention_sm90_refuses_misaligned_views(cuda):
    B, S, H, D = 1, 256, 4, 128
    flat = torch.randn(B * S * H * D + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(B, S, H, D)          # an odd element offset: 2 bytes off
    k = torch.randn(B, S, H, D, device=cuda).to(torch.bfloat16)
    before = fa_ops.launches
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q, k, k)
    wide = torch.randn(B, S, H, D + 1, device=cuda).to(torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="stride"):
        fa_ops.flash_attention(k, wide, k)
    assert fa_ops.launches == before


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype,a_fixed", [
    (1, 32, 2, 8, 4, 8, torch.float32, None),
    (2, 64, 2, 16, 8, 16, torch.float32, None),
    (1, 48, 4, 8, 8, 16, torch.float32, None),       # ragged
    (2, 16, 1, 8, 4, 16, torch.float32, None),       # single chunk
    (2, 300, 3, 64, 64, 128, torch.bfloat16, None),  # ragged, bf16, shared B/C
    (2, 256, 4, 64, 64, 128, torch.float32, -1.0),   # where exp(L_i - L_j) overflows
    (4, 1024, 64, 64, 64, 128, torch.bfloat16, None),  # zamba2-1.2b's prefill
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype, a_fixed):
    """The scalar kernel, called by its own launcher (the bf16 cases at
    N = P = 64 take the sm90 route through ssd)."""
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, B, S, H, P, N, dtype, a_fixed, S + H)
    y, state = ssd_ops.ssd_scalar(x, dt, Bm, Cm, a, chunk=chunk)
    want_y, want_state = ssd_scan_torch(x, dt, Bm, Cm, a, chunk=chunk)
    _assert_ssd_close(y, state, want_y, want_state, (B, S, H, P), (B, H, N, P), dtype)


def _ssd_inputs(cuda, B, S, H, P, N, dtype, a_fixed, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    # x is a strided view (every other head of a wider tensor), as the
    # kernels read it through its strides
    x = (torch.randn(B, S, 2 * H, P, generator=gen, device=cuda) * 0.5).to(dtype)[:, :, ::2]
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=cuda))
    Bm, Cm = ((torch.randn(B, S, N, generator=gen, device=cuda) * 0.5).to(dtype)
              for _ in range(2))
    a = (torch.full((H,), a_fixed, device=cuda) if a_fixed is not None else
         -torch.exp(torch.randn(H, generator=gen, device=cuda) * 0.3))
    return x, dt, Bm, Cm, a


def _assert_ssd_close(y, state, want_y, want_state, y_shape, state_shape, dtype):
    assert y.dtype == dtype and y.shape == y_shape and state.shape == state_shape
    floor = 1e-4 * (1 + want_y.float().abs().max().item())
    tol = floor + (2.0 ** -7 * want_y.float().abs() if dtype == torch.bfloat16 else 0)
    assert torch.isfinite(y).all() and ((y.float() - want_y.float()).abs() <= tol).all()
    st_tol = 1e-4 * (1 + want_state.abs().max().item())
    assert (state - want_state).abs().max().item() <= st_tol


def test_ssd_kernel_rejects_what_it_does_not_cover(cuda):
    x = torch.zeros(1, 256, 1, 128, device=cuda)
    dt, a = torch.ones(1, 256, 1, device=cuda), -torch.ones(1, device=cuda)
    Bm = torch.zeros(1, 256, 128, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd(x, dt, Bm, Bm, a, chunk=128)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(x[..., :64], dt, Bm[..., :64], Bm[..., :64], a, chunk=256)
    with pytest.raises(ValueError, match="decay_dtype"):
        ssd_ops.ssd(x[..., :64], dt, Bm[..., :64], Bm[..., :64], a, chunk=128,
                    decay_dtype=torch.float16)


@pytest.mark.parametrize("B,S,H,chunk,a_fixed", [
    (2, 300, 4, 64, None),      # ragged at 64
    (2, 128, 4, 128, None),     # one full chunk
    (2, 1000, 8, 128, None),    # ragged at 128
    (2, 300, 3, 128, None),     # H not a multiple of the kernel's head tile
    (1, 40, 3, 128, None),      # one chunk of 40 steps
    (2, 100, 5, 30, None),      # a chunk that is not a multiple of 16
    (2, 256, 4, 128, -1.0),     # where exp(L_i - L_j) overflows above the diagonal
    (4, 1024, 64, 128, None),   # zamba2-1.2b's prefill
])
def test_ssd_sm90_matches_plain(cuda, B, S, H, chunk, a_fixed):
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, B, S, H, 64, 64, torch.bfloat16, a_fixed, S + H + 1)
    assert ssd_ops.route(x, Bm) == "sm90"
    sm90, scalar = ssd_ops.launches_sm90, ssd_ops.launches_scalar
    y, state = ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=chunk)
    assert (ssd_ops.launches_sm90, ssd_ops.launches_scalar) == (sm90 + 1, scalar)
    want_y, want_state = ssd_ops.ssd_plain(x, dt, Bm, Cm, a, chunk=chunk)
    _assert_ssd_close(y, state, want_y, want_state, (B, S, H, 64), (B, H, 64, 64),
                      torch.bfloat16)


def test_ssd_sm90_refuses_what_it_does_not_take(cuda):
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, 1, 256, 4, 64, 64, torch.bfloat16, None, 0)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="bf16"):
        ssd_ops.ssd_sm90(x.float(), dt, Bm.float(), Cm.float(), a)
    with pytest.raises(ValueError, match="bf16"):
        ssd_ops.ssd_sm90(x[..., :32], dt, Bm[..., :32], Cm[..., :32], a)
    flat = torch.zeros(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ssd_ops.ssd(flat[1:].view(x.shape), dt, Bm, Cm, a)
    wide = torch.zeros(1, 256, 65, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="stride"):
        ssd_ops.ssd(x, dt, wide, Cm, a)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=256)
    with pytest.raises(ValueError, match="decay_dtype"):
        ssd_ops.ssd(x, dt, Bm, Cm, a, decay_dtype=torch.float16)
    assert ssd_ops.launches == before


@pytest.mark.parametrize("layout", ["einsum", "columns"])
@pytest.mark.parametrize("B,H,N,P", [
    (64, 64, 64, 64),   # zamba2-1.2b's chat decode step
    (8, 64, 64, 64),    # its longprompt decode step: P split in two
    (4, 8, 16, 16),     # the smoke model
])
def test_ssd_step_matches_plain(cuda, B, H, N, P, layout):
    """The decode step's kernel against its plain version, with bf16 x read
    as the conv output [B, H·P] viewed [B, H, P], in the layout the conv's
    einsum leaves on the card (strides (1, B)) or as a wider tensor's
    columns (a batch stride that is not H·P).  Each new state element is rounded
    as the plain ops round it, so the state agrees within a few fp32 ulps,
    1e-6·(1 + max|want|) (``expf`` beside torch's exp); y, summed over N in
    another order, within one bf16 rounding flip, 2**-7 |want|, above a
    floor of 1e-4·(1 + max|want|).  The state is written in place and the
    launch is counted."""
    gen = torch.Generator(device=cuda).manual_seed(B + N)
    state = torch.randn(B, H, N, P, generator=gen, device=cuda)
    if layout == "einsum":
        conv = torch.randn(H * P, B, generator=gen, device=cuda).to(torch.bfloat16).t()
    else:
        conv = torch.randn(B, 2 * H * P, generator=gen, device=cuda).to(torch.bfloat16)
        conv = conv[:, :H * P]
    x = conv.view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=gen, device=cuda))
    a = -torch.exp(torch.randn(H, generator=gen, device=cuda) * 0.3)
    Bm, Cm = (torch.randn(B, N, generator=gen, device=cuda) * 0.5 for _ in range(2))
    d_skip = torch.randn(H, generator=gen, device=cuda).to(torch.bfloat16)
    want_state = state.clone()
    want = ssd_ops.ssd_step_plain(want_state, x, dt, a, Bm, Cm, d_skip)
    before, ptr = ssd_ops.step_launches, state.data_ptr()
    y = ssd_ops.ssd_step(state, x, dt, a, Bm, Cm, d_skip)
    torch.cuda.synchronize()
    assert ssd_ops.step_launches == before + 1 and state.data_ptr() == ptr
    assert y.dtype == torch.bfloat16 and y.shape == (B, H, P)
    st_err = (state - want_state).abs().max().item()
    assert st_err <= 1e-6 * (1 + want_state.abs().max().item()), st_err
    floor = 1e-4 * (1 + want.float().abs().max().item())
    assert ((y.float() - want.float()).abs() <= floor + 2.0 ** -7 * want.float().abs()).all()


def _grouped_bc(cuda, B, S, G, N, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn(B, S, G, N, generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
            for _ in "BC"]


@pytest.mark.parametrize("B,S,H,G,chunk", [
    (2, 300, 16, 2, 128),       # ragged at 128, two groups of 8 heads
    (1, 40, 8, 1, 128),         # one chunk of 40 steps, one group
    (2, 100, 16, 2, 30),        # a chunk that is not a multiple of 16
    (2, 1000, 12, 1, 128),      # H not a multiple of the kernel's head tile, one group
    (8, 4096, 64, 8, 128),      # Nemotron 3 Nano's prefill at its longest
])
def test_ssd_sm90_n128_in_groups_matches_plain(cuda, B, S, H, G, chunk):
    """K3-sm90's N 128 instance, B and C [B, S, G, 128]: one sm90 launch,
    within ``_assert_ssd_close`` of the route's plain version; and, the scan
    being separable over N, within two bf16 roundings of the two N 64
    halves' y through the N 64 instance, its state their concatenation
    within 1e-4·(1 + max|state|)."""
    x, dt, _, _, a = _ssd_inputs(cuda, B, S, H, 64, 128, torch.bfloat16, None, S + H)
    Bm, Cm = _grouped_bc(cuda, B, S, G, 128, S + H + 1)
    assert ssd_ops.route(x, Bm) == "sm90"
    sm90 = ssd_ops.launches_sm90
    y, state = ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=chunk)
    assert ssd_ops.launches_sm90 == sm90 + 1
    want_y, want_state = ssd_ops.ssd_plain(x, dt, Bm, Cm, a, chunk=chunk)
    _assert_ssd_close(y, state, want_y, want_state, (B, S, H, 64), (B, H, 128, 64),
                      torch.bfloat16)
    y1, s1 = ssd_ops.ssd(x, dt, Bm[..., :64], Cm[..., :64], a, chunk=chunk)
    y2, s2 = ssd_ops.ssd(x, dt, Bm[..., 64:], Cm[..., 64:], a, chunk=chunk)
    halves = y1.float() + y2.float()
    tol = 2.0 ** -7 * (y1.float().abs() + y2.float().abs() + y.float().abs()) \
        + 1e-4 * (1 + halves.abs().max().item())
    assert ((y.float() - halves).abs() <= tol).all()
    st = torch.cat([s1, s2], 2)
    assert (state - st).abs().max().item() <= 1e-4 * (1 + st.abs().max().item())


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_sm90_one_group_is_every_group_alike(cuda, N):
    """The group's offset changes no arithmetic: [B, S, N] (zamba2's
    layout), [B, S, 1, N] and 8 identical groups give the same bits."""
    B, S, H = 2, 700, 64
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, B, S, H, 64, N, torch.bfloat16, None, N)
    y, state = ssd_ops.ssd(x, dt, Bm, Cm, a)
    for g in (1, 8):
        yg, sg = ssd_ops.ssd(x, dt, Bm[:, :, None].repeat(1, 1, g, 1),
                             Cm[:, :, None].repeat(1, 1, g, 1), a)
        assert torch.equal(yg, y) and torch.equal(sg, state)


@pytest.mark.parametrize("B,H,G,N,P", [
    (8, 64, 8, 128, 64),    # Nemotron 3 Nano's longprompt decode step
    (64, 64, 8, 128, 64),   # at a batch of 64
    (4, 8, 2, 16, 8),       # the smoke model
])
def test_ssd_step_in_groups_matches_plain(cuda, B, H, G, N, P):
    """The decode step's kernel with B and C [B, G, N] against its plain
    version (``test_ssd_step_matches_plain``'s tolerances), and one group
    [B, 1, N] against the shared [B, N] bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(B + G + N)
    state = torch.randn(B, H, N, P, generator=gen, device=cuda)
    x = torch.randn(H * P, B, generator=gen, device=cuda).to(torch.bfloat16).t().view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=gen, device=cuda))
    a = -torch.exp(torch.randn(H, generator=gen, device=cuda) * 0.3)
    Bm, Cm = (torch.randn(B, G, N, generator=gen, device=cuda) * 0.5 for _ in range(2))
    d_skip = torch.randn(H, generator=gen, device=cuda).to(torch.bfloat16)
    want_state = state.clone()
    want = ssd_ops.ssd_step_plain(want_state, x, dt, a, Bm, Cm, d_skip)
    before = ssd_ops.step_launches
    got_state = state.clone()
    y = ssd_ops.ssd_step(got_state, x, dt, a, Bm, Cm, d_skip)
    torch.cuda.synchronize()
    assert ssd_ops.step_launches == before + 1
    st_err = (got_state - want_state).abs().max().item()
    assert st_err <= 1e-6 * (1 + want_state.abs().max().item()), st_err
    floor = 1e-4 * (1 + want.float().abs().max().item())
    assert ((y.float() - want.float()).abs() <= floor + 2.0 ** -7 * want.float().abs()).all()
    shared, one = state.clone(), state.clone()
    y_shared = ssd_ops.ssd_step(shared, x, dt, a, Bm[:, 0], Cm[:, 0], d_skip)
    y_one = ssd_ops.ssd_step(one, x, dt, a, Bm[:, :1], Cm[:, :1], d_skip)
    assert torch.equal(y_shared, y_one) and torch.equal(shared, one)


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ragged_experts_grouped_match_the_loop(cuda, act, dtype):
    """The prefill's dropless experts on the card, one grouped GEMM a
    projection, against the same experts an expert at a time in fp32 on the
    same rows: runs of uneven sizes, two experts with none.  bf16: within
    one bf16 rounding of each product, 2**-7 of the output's largest
    magnitude; fp32: 1e-5 of it (the GEMM kernels sum in other orders)."""
    from repro_torch.models import moe

    layer = moe.MoE(torch.Generator(device=cuda).manual_seed(0), 256, 128, 8, device=cuda,
                    act=act)
    sizes = [5, 0, 130, 17, 0, 64, 1, 300]
    xs = torch.randn(sum(sizes), 256, generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda).to(dtype)
    got = moe._ragged_experts(layer, xs, sizes, torch.tensor(sizes, device=cuda))
    outs, a = [], 0
    for e, n in enumerate(sizes):
        x = xs[a:a + n].float()
        u = x @ layer.wu[e].float()
        h = (torch.square(torch.relu(u)) if act == "relu2"
             else torch.nn.functional.silu(x @ layer.wg[e].float()) * u)
        outs.append(h @ layer.wd[e].float())
        a += n
    want = torch.cat(outs)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


def _bf16_decay_tol(x, dt, Bm, Cm, a, chunk):
    """The bf16-decay forms' tolerance beyond ``_assert_ssd_close``'s: the
    kernel and its plain version round G = C·Bᵀ to bf16 after sums of
    another order, so a term may differ by one bf16 ulp, 2**-7 of itself;
    summed, 2**-7 of y_abs (the scan on |x|, |B| and |C|)."""
    y_abs, _ = ssd_scan_torch(x.float().abs(), dt, Bm.float().abs(), Cm.float().abs(), a,
                              chunk)
    return 2.0 ** -7 * y_abs


@pytest.mark.parametrize("route", ["sm90", "scalar"])
@pytest.mark.parametrize("B,S,H,chunk,a_fixed", [
    (2, 300, 4, 64, None),      # ragged at 64
    (2, 1000, 8, 128, None),    # ragged at 128
    (2, 100, 5, 30, None),      # a chunk that is not a multiple of 16
    (2, 256, 4, 128, -1.0),     # where exp(L_i - L_j) overflows above the diagonal
    (4, 1024, 64, 128, None),   # zamba2-1.2b's prefill
])
def test_ssd_bf16_decay_matches_plain(cuda, route, B, S, H, chunk, a_fixed):
    """Both kernels' bf16-decay forms against their plain versions (bf16 x,
    B and C at N = P = 64)."""
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, B, S, H, 64, 64, torch.bfloat16, a_fixed, S + H + 2)
    bf = torch.bfloat16
    if route == "sm90":
        y, state = ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=chunk, decay_dtype=bf)
        want_y, want_state = ssd_ops.ssd_plain(x, dt, Bm, Cm, a, chunk=chunk, decay_dtype=bf)
    else:
        y, state = ssd_ops.ssd_scalar(x, dt, Bm, Cm, a, chunk=chunk, decay_dtype=bf)
        want_y, want_state = ssd_scan_torch(x, dt, Bm, Cm, a, chunk=chunk, decay_dtype=bf)
    extra = _bf16_decay_tol(x, dt, Bm, Cm, a, chunk)
    floor = 1e-4 * (1 + want_y.float().abs().max().item())
    tol = floor + 2.0 ** -7 * want_y.float().abs() + extra
    assert torch.isfinite(y).all() and ((y.float() - want_y.float()).abs() <= tol).all()
    assert (state - want_state).abs().max().item() <= 1e-4 * (1 + want_state.abs().max().item())
    # the fp32 decay differs: the bf16 form is a form of its own
    assert not torch.equal(y, ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=chunk)[0])


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
def test_family_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """Model-level prefill and one decode step, card against CPU, at smoke
    size in fp32 (vlm with patch embeddings and positions3); every prefill
    layer launches K2 once."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, device="cpu")
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    B, S = 2, 40
    rng = np.random.default_rng(0)
    shape = (B, cfg.codebooks, S) if cfg.family == "audio" else (B, S)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape))}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
        batch["patch_positions"] = torch.arange(4, 4 + P).repeat(B, 1)
        pos3 = torch.arange(S)[None, :, None].repeat(B, 1, 3)
        pos3[:, 4:4 + P, 1] += torch.arange(P) % 3
        batch["positions3"] = pos3
    before = fa_ops.launches
    got, got_cache = card.prefill({k: v.to(cuda) for k, v in batch.items()}, max_len=S + 2)
    assert fa_ops.launches == before + cfg.n_layers
    want, want_cache = cpu.prefill(batch, max_len=S + 2)

    def close(a, b):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * (1 + b.abs().max().item())

    close(got, want)
    for key in ("ckv", "kr") if cfg.family == "mla_moe" else ("k", "v"):
        close(got_cache[key], want_cache[key])
    tok = want.argmax(-1)[..., None]
    got, _ = card.decode(got_cache, {"tokens": tok.to(cuda)})
    want, _ = cpu.decode(want_cache, {"tokens": tok})
    close(got, want)


def test_deepseek_prefill_in_bf16_takes_the_sm90_route(cuda):
    """deepseek-v2 at smoke depth and width but with its published head
    dims (nope 128 + rope 64, v 128), in bf16: every prefill layer launches
    K2's sm90 route once and the scalar route never; the logits are finite,
    and each layer's K2 output is within one bf16 flip of the sm90 plain
    version on that layer's own inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, layers

    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True), dtype=torch.bfloat16,
                              head_dim=192, nope_head_dim=128, rope_head_dim=64,
                              v_head_dim=128)
    model = Model(cfg, device=cuda)
    B, S = 2, 200
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    real, excess = layers.flash_attention, []

    def checked(q, k, v, causal=True):
        got = real(q, k, v, causal=causal)
        want = fa_ops.flash_attention_plain(q, k, v, causal=causal).float()
        excess.append(((got.float() - want).abs() - (2.0 ** -7 * want.abs() + 1e-3)).max())
        return got

    before = (fa_ops.launches_sm90, fa_ops.launches_scalar)
    layers.flash_attention = checked
    try:
        logits, _ = model.prefill({"tokens": tokens.to(cuda)}, max_len=S + 2)
    finally:
        layers.flash_attention = real
    assert (fa_ops.launches_sm90, fa_ops.launches_scalar) == (before[0] + cfg.n_layers,
                                                              before[1])
    assert torch.isfinite(logits.float()).all()
    assert len(excess) == cfg.n_layers and max(x.item() for x in excess) <= 0


# ------------------------------------------------- K2 and K3 under autograd ----
def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


@pytest.mark.parametrize("route,dtype,D,Dv,causal", [
    ("sm90", torch.bfloat16, 128, 128, True),
    ("sm90", torch.bfloat16, 64, 64, False),
    ("sm90", torch.bfloat16, 192, 128, True),
    ("scalar", torch.float32, 64, 64, True),
    ("scalar", torch.bfloat16, 32, 32, True),
])
def test_flash_attention_gradients_through_the_function(cuda, route, dtype, D, Dv, causal):
    """K2 forward, plain backward: one launch and one backward call; the
    gradients equal autograd through attention_chunked (which the backward
    recomputes) within 1e-6 relative L2, and autograd through the route's
    plain version within 2**-6 in bf16 (bf16 gradients, another rounding of
    the forward's intermediates) and 1e-4 in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(D + Dv)
    B, S, Hq, Hkv = 2, 300, 8, 2
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    g = torch.randn(B, S, Hq, Dv, generator=gen, device=cuda).to(dtype)
    assert fa_ops.route(q, k, v) == route
    leaves = _leaves(q, k, v)
    launches, calls = fa_ops.launches, fa_ops.backward_calls
    fa_ops.flash_attention(*leaves, causal=causal).backward(g)
    assert (fa_ops.launches, fa_ops.backward_calls) == (launches + 1, calls + 1)

    from repro_torch.models.layers import attention_chunked

    chunked = _leaves(q, k, v)
    attention_chunked(*chunked, causal=causal).backward(g)
    plain = _leaves(q, k, v)
    fa_ops.flash_attention_plain(*plain, causal=causal).backward(g)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, a, b in zip(leaves, chunked, plain):
        assert got.grad.dtype == dtype and torch.isfinite(got.grad).all()
        assert _rel_l2(got.grad, a.grad) <= 1e-6
        assert _rel_l2(got.grad, b.grad) <= tol


@pytest.mark.parametrize("route,dtype,P,N", [("sm90", torch.bfloat16, 64, 64),
                                             ("scalar", torch.float32, 32, 16)])
def test_ssd_gradients_through_the_function(cuda, route, dtype, P, N):
    """K3 forward, plain backward, through y and the final state, with x a
    strided view of a leaf: one launch and one backward call; the gradients
    equal autograd through ssd_scan_torch (which the backward recomputes)
    within 1e-6 relative L2, and autograd through the route's plain version
    within 2**-6 in bf16 and 1e-4 in fp32."""
    B, S, H = 2, 300, 4
    x, dt, Bm, Cm, a = _ssd_inputs(cuda, B, S, H, P, N, dtype, None, 7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    gy = torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype)
    gs = torch.randn(B, H, N, P, generator=gen, device=cuda)
    wide = torch.zeros(B, S, 2 * H, P, device=cuda, dtype=dtype)
    wide[:, :, ::2] = x

    def run(fn):
        w, *rest = _leaves(wide, dt, Bm, Cm, a)
        y, state = fn(w[:, :, ::2], *rest, 64)
        ((y.float() * gy.float()).sum() + (state * gs).sum()).backward()
        return [w.grad[:, :, ::2], *(t.grad for t in rest)]

    assert ssd_ops.route(x, Bm) == route
    launches, calls = ssd_ops.launches, ssd_ops.backward_calls
    got = run(ssd_ops.ssd)
    assert (ssd_ops.launches, ssd_ops.backward_calls) == (launches + 1, calls + 1)
    recomputed = run(ssd_scan_torch)
    plain = run(ssd_ops.ssd_plain)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for g, a_, b in zip(got, recomputed, plain):
        assert torch.isfinite(g).all()
        assert _rel_l2(g, a_) <= 1e-6
        assert _rel_l2(g, b) <= tol


def test_llama_train_step_on_the_card_matches_the_cpu(cuda):
    """One make_train_step of llama3.2-3b's smoke config in fp32
    activations, card against CPU on the same weights and batch: every
    layer launches K2 (its scalar route: fp32) once in the forward and once
    more in remat's recompute (the config's default, "full"), and its plain
    backward once; the loss within 1e-5 relative, every gradient (bf16) and moment
    within 2**-7 relative L2, every parameter within one bf16 ulp plus two
    steps where a noise-level gradient flips (tests/_train_step_compare.py
    says why)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training.data import SyntheticData
    from repro_torch.training.optimizer import AdamW, warmup_cosine
    from repro_torch.training.train_step import make_train_step

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True), dtype=torch.float32)
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticData(cfg.vocab, 32, 4, seed=1).batch_at(0).items()}
    runs = {}
    for dev in ("cpu", cuda):
        model = Model(cfg, device="cpu")
        model.to(dev)
        opt = AdamW(lr=warmup_cosine(1e-2, warmup=0, total=10 ** 6))
        step = make_train_step(model, opt)
        launches, calls = fa_ops.launches, fa_ops.backward_calls
        state, metrics = step(opt.init(dict(model.named_parameters())),
                              {k: v.to(dev) for k, v in batch.items()})
        if dev != "cpu":
            assert (cfg.remat, cfg.remat_policy) == (True, "full")
            assert fa_ops.launches == launches + 2 * cfg.n_layers
            assert fa_ops.backward_calls == calls + cfg.n_layers
        runs[str(dev)] = (float(metrics["loss"]), state,
                          {k: p.detach().cpu() for k, p in model.named_parameters()})
    (lc, sc, pc), (lg, sg, pg) = runs["cpu"], runs[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k in pc:
        for mom in ("m", "v"):
            assert _rel_l2(sg[mom][k].cpu(), sc[mom][k]) <= 2.0 ** -7, (mom, k)
        want = pc[k].float()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        assert ((pg[k].float() - want).abs() <= 2 * 1e-2 * 1.1 + 2 * ulp).all(), k


@pytest.fixture
def card_mesh(cuda, tmp_path):
    """The card's host mesh (1,) ("data",) over a one-rank NCCL group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def test_kernels_through_local_map_on_the_card_mesh(card_mesh):
    """K2 and K3 given DTensors on the (1,) mesh run their kernel once each
    on the local shards, with the meshless call's result bit for bit."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Resolver, activate

    r = Resolver(get_config("llama3.2-3b"), card_mesh)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 256, h, 128, generator=g, device="cuda").bfloat16()
               for h in (8, 2, 2))
    x = torch.randn(2, 256, 4, 64, generator=g, device="cuda").bfloat16()
    dt = torch.rand(2, 256, 4, generator=g, device="cuda")
    Bm, Cm = (torch.randn(2, 256, 64, generator=g, device="cuda").bfloat16() for _ in "BC")
    a = -torch.rand(4, generator=g, device="cuda")

    def on_mesh(t, axes):
        return distribute_tensor(t, card_mesh, r(axes, t.shape))

    attn = ("batch", "seq", "heads", None)
    want_o = fa_ops.flash_attention(q, k, v)
    want_y, want_s = ssd_ops.ssd(x, dt, Bm, Cm, a, 128)
    fa0, ssd0 = fa_ops.launches_sm90, ssd_ops.launches_sm90
    with activate(r):
        o = fa_ops.flash_attention(*(on_mesh(t, attn) for t in (q, k, v)))
        y, s = ssd_ops.ssd(on_mesh(x, attn), on_mesh(dt, attn[:3]),
                           on_mesh(Bm, ("batch", "seq", None)),
                           on_mesh(Cm, ("batch", "seq", None)), on_mesh(a, ("heads",)), 128)
    assert (fa_ops.launches_sm90 - fa0, ssd_ops.launches_sm90 - ssd0) == (1, 1)
    assert torch.equal(o.full_tensor(), want_o)
    assert torch.equal(y.full_tensor(), want_y) and torch.equal(s.full_tensor(), want_s)


def test_ssd_step_through_local_map_on_the_card_mesh(card_mesh):
    """The decode step's state update given DTensors on the (1,) mesh, its
    state split on the batch as the cache holds it: one launch of
    ``csrc/ssd_step.cu`` on the local shards, the meshless call's y and new
    state bit for bit, the state updated in place."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    g = torch.Generator(device="cuda").manual_seed(6)
    B, H, N, P = 4, 8, 16, 16
    state = torch.randn(B, H, N, P, generator=g, device="cuda")
    x = torch.randn(H * P, B, generator=g, device="cuda").bfloat16().t().view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=g, device="cuda"))
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    Bm, Cm = (torch.randn(B, N, generator=g, device="cuda") for _ in "BC")
    d_skip = torch.randn(H, generator=g, device="cuda").bfloat16()
    st = distribute_tensor(state, card_mesh, [Shard(0)])
    rest = [distribute_tensor(t, card_mesh, [Replicate()]) for t in (x, dt, a, Bm, Cm, d_skip)]
    want_state = state.clone()
    want = ssd_ops.ssd_step(want_state, x, dt, a, Bm, Cm, d_skip)
    before = ssd_ops.step_launches
    y = ssd_ops.ssd_step(st, *rest)
    assert ssd_ops.step_launches == before + 1
    assert torch.equal(y.full_tensor(), want) and torch.equal(st.full_tensor(), want_state)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "qwen2-vl-72b",
                                  "xlstm-1.3b"])
def test_family_loss_on_the_card_mesh(card_mesh, arch):
    """The family's smoke model at 2 layers in fp32 on the card: one loss
    forward and backward on the (1,) mesh against the same without it,
    the loss and every gradient within 1e-5 relative; K2 launches in each
    attention layer (the forward and remat's recompute) both ways."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Resolver, activate, distribute_model
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, n_layers=2)
    model = Model(cfg, device="cuda", seed=0).float().requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S = 4, 32
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(B, cfg.n_patches, cfg.d_model, generator=g,
                                            device="cuda")
        batch["patch_positions"] = torch.arange(3, 3 + cfg.n_patches, device="cuda").repeat(B, 1)
    attn = 0 if cfg.family == "xlstm" else 2 * cfg.n_layers
    n = fa_ops.launches
    loss = model.loss(batch)[0]
    loss.backward()
    assert fa_ops.launches - n == attn
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    r = Resolver(cfg, card_mesh)
    distribute_model(model, r)
    mbatch = {k: distribute_tensor(v, card_mesh, r(("batch",) + (None,) * (v.dim() - 1), v.shape))
              for k, v in batch.items()}
    n = fa_ops.launches
    with activate(r):
        got = model.loss(mbatch)[0]
        got.backward()
    assert fa_ops.launches - n == attn
    assert abs(got.full_tensor().item() - loss.item()) <= 1e-5 * abs(loss.item())
    for k, p in model.named_parameters():
        w = want[k]
        assert (p.grad.full_tensor() - w).norm() <= 1e-5 * w.norm(), k


def _greedy(model, decode, tokens, max_len, steps):
    """Prefill, then ``steps`` greedy steps by ``decode`` → (the tokens fed
    [B, steps], every step's logits [steps, B, V])."""
    logits, cache = model.prefill({"tokens": tokens}, max_len=max_len)
    tok = logits.argmax(-1)[:, None]
    outs, seen = [], []
    for _ in range(steps):
        outs.append(tok)
        logits, cache = decode(cache, {"tokens": tok})
        seen.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.cat(outs, 1), torch.stack(seen)


def _op_by_op(model):
    """``Model.decode``'s op-by-op route on the card: ``decode_in_place``
    run outside a graph, at an int ``pos``, on a clone of the cache."""
    def decode(cache, batch):
        work = {k: v.clone() for k, v in cache.items() if k != "pos"}
        return model.decode_in_place(work, batch, cache["pos"]), {**work, "pos": cache["pos"] + 1}
    return decode


@pytest.mark.parametrize("arch,n_experts", [
    pytest.param("zamba2-1.2b", None, id="zamba2-1.2b"),
    pytest.param("llama3.2-3b", None, id="llama3.2-3b"),
    pytest.param("deepseek-v2-236b", None, id="deepseek-v2-236b"),
    pytest.param("nemotron-3-nano-30b-a3b", None, id="nemotron-3-nano-30b-a3b"),
    pytest.param("deepseek-v2-236b", 16, id="deepseek-v2-236b-e16"),
    pytest.param("nemotron-3-nano-30b-a3b", 16, id="nemotron-3-nano-30b-a3b-e16"),
])
def test_decode_graph_replays_the_eager_step(cuda, arch, n_experts):
    """The smoke model in bf16 (deepseek-v2 with its published head dims
    and every published option: group-limited ×16 unnormalised, dropless, a
    held share, YaRN, left pads unrouted; nemotron-h's pattern of Mamba2,
    sigmoid-routed relu² MoE and NoPE attention blocks, left pads
    unrouted).  The MoE's decode steps at top-2: with the smoke model's 8
    experts, B 4 has T·k = E and takes C = T, B 2 has T·k < E and runs the
    experts grouped over the slots; with 16 experts both run grouped
    (deepseek-v2's share of 4 then often holds no slot of a step).  Greedy
    decode by the replayed
    graph gives the step run op by op its tokens and logits bit for bit
    over 32 steps, capturing one graph for its (B, max_len) and replaying it
    at every step, the prefill's cache left as it was, and adds to the MoE's
    running sums what the op-by-op steps add (the warm-up before a capture
    adds nothing); a second (B, max_len) captures a second graph, and the
    first key again replays the first."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, decode_graph
    from repro_torch.models.layers import YaRN

    cfg = get_config(arch, smoke=True)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
    if cfg.family == "mla_moe":
        cfg = dataclasses.replace(
            cfg, head_dim=192, nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
            n_group=4, topk_group=2, norm_topk_prob=False, routed_scaling_factor=16.0,
            capacity_factor=None, experts_held=(2, 4), unrouted_pad=0,
            rope_scaling=YaRN(factor=40, original_max_position_embeddings=4096,
                              mscale=0.707, mscale_all_dim=0.707))
    if cfg.family == "nemotron_h":
        cfg = dataclasses.replace(cfg, unrouted_pad=0)
    assert cfg.dtype == torch.bfloat16
    model = Model(cfg, device="cuda", seed=0)
    assert decode_graph.replays(model)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(1, cfg.vocab, (4, 24), generator=g, device="cuda")
    if cfg.unrouted_pad is not None:
        tokens[0, :5] = cfg.unrouted_pad                # left pads
    want, want_logits = _greedy(model, _op_by_op(model), tokens, 64, 32)
    # the MoE's running sums after one prefill and the op-by-op steps
    sums = None if model.moe_sums is None else model.moe_sums.clone()
    assert model.decode_graph_captures == model.decode_graph_replays == 0
    got, got_logits = _greedy(model, model.decode, tokens, 64, 32)
    assert (model.decode_graph_captures, model.decode_graph_replays) == (1, 32)
    assert torch.equal(got, want) and torch.equal(got_logits, want_logits)
    if sums is not None:
        assert torch.equal(model.moe_sums, 2 * sums)

    logits, cache = model.prefill({"tokens": tokens}, max_len=64)
    kept = {k: v.clone() for k, v in cache.items() if k != "pos"}
    first, _ = model.decode(cache, {"tokens": logits.argmax(-1)[:, None]})
    assert all(torch.equal(cache[k], v) for k, v in kept.items())
    again, _ = model.decode(cache, {"tokens": logits.argmax(-1)[:, None]})
    assert torch.equal(first, again) and torch.equal(first, want_logits[0])

    small, small_logits = _greedy(model, _op_by_op(model), tokens[:2], 40, 8)
    got, got_logits = _greedy(model, model.decode, tokens[:2], 40, 8)
    assert (model.decode_graph_captures, model.decode_graph_replays) == (2, 42)
    assert torch.equal(got, small) and torch.equal(got_logits, small_logits)
    got, _ = _greedy(model, model.decode, tokens, 64, 32)
    assert (model.decode_graph_captures, model.decode_graph_replays) == (2, 74)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="past the cache"):
        model.decode({**cache, "pos": 64}, {"tokens": logits.argmax(-1)[:, None]})


def test_decode_on_the_card_mesh_stays_eager(card_mesh):
    """zamba2's smoke model in fp32 on the (1,) mesh: ``decode`` runs the
    step op by op (its parameters are DTensors), captures nothing, and
    agrees with the meshless op-by-op step within 1e-4·(1 + max|want|)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Resolver, activate, distribute_model
    from repro_torch.models import Model, decode_graph

    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True), dtype=torch.float32)
    model = Model(cfg, device="cuda", seed=0).float()
    g = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(1, cfg.vocab, (4, 16), generator=g, device="cuda")
    nxt = {"tokens": tokens[:, -1:]}
    _, cache = model.prefill({"tokens": tokens}, max_len=32)
    want, _ = _op_by_op(model)(cache, nxt)
    r = Resolver(cfg, card_mesh)
    distribute_model(model, r)
    assert not decode_graph.replays(model)
    batch, nxt = ({"tokens": distribute_tensor(d["tokens"], card_mesh,
                                               r(("batch", None), d["tokens"].shape))}
                  for d in ({"tokens": tokens}, nxt))
    with activate(r):
        _, cache = model.prefill(batch, max_len=32)
        got, cache = model.decode(cache, nxt)
    assert model.decode_graph_captures == model.decode_graph_replays == 0
    assert cache["pos"] == 17
    err = float((got.full_tensor() - want).abs().max())
    assert err <= 1e-4 * (1 + float(want.abs().max())), err
