"""Wrappers of the two SSD scan kernels.

``ssd`` keeps the model's [B,S,H,P] layout at its interface, with B and C
shared across heads as [B,S,N].  On CUDA tensors it launches one of two
hand-written kernels, which ``route`` picks from dtype and shape alone,
before any launch:

- ``"sm90"`` (``csrc/ssd_scan_sm90.cu``): bf16 x, B and C with N = P = 64,
  every Mamba2 prefill layer of zamba2-1.2b.  mma.sync bf16 tensor cores,
  split into three kernels over (batch, chunk, head tile); x, B and C must
  meet its 16-byte copies (``copy_check``), or the wrapper raises
  ``ValueError``.
- ``"scalar"`` (``csrc/ssd_scan.cu``): every other input (fp32, other N or
  P), on the CUDA cores.

Both read x, dt, B and C through their strides (no transpose and no
per-head copies of B and C).  No route falls back to another, and nothing
falls back to the plain version: a refused input or a failed launch raises.
On CPU tensors ``ssd`` runs the plain version of the route the inputs would
take on the card (``ssd_plain``).  This is the one place the model's SSD
picks its device.  ``launches`` counts the calls that launched either
route, ``launches_sm90`` and ``launches_scalar`` each route's; one sm90
call launches three CUDA kernels and counts as one.

On the card the kernel runs inside ``SSDFn``, an autograd Function: its
forward is the route's kernel, its backward recomputes ``ssd_scan_torch``
(without the two-term split) in plain torch from the saved inputs and
backpropagates through it (the JAX package has no backward kernel).
``backward_calls`` counts those backward passes.  Without autograd
(serving) the forward is the same one launch.  On DTensors (the mesh path)
each rank runs the route on its local shards (``kernels._mesh``): batch
and heads may be split; B and C follow the batch split, a the heads'.
"""
from __future__ import annotations

import torch

from .. import _cuda, _mesh
from .ref import ssd_scan_torch

launches = 0
launches_sm90 = 0
launches_scalar = 0
backward_calls = 0

_DTYPES = (torch.float32, torch.bfloat16)
DECAY_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448    # bytes of shared memory a block may opt into on sm_90
MAX_CHUNK = 128         # the kernels' tiles hold at most 128 steps
SM90_DIMS = (64,)       # N = P of the sm90 route
# each route's plain version: the arguments of ssd_scan_torch
PLAIN_ARGS = {"sm90": {"split": True}, "scalar": {}}


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block of the scalar kernel, as
    ``ssd_scan.cu`` lays it out: the [N,P] state, the x tile, the B and C
    tiles (rows padded by one), the [Q,Q] mixing tile and four per-step
    vectors, all fp32."""
    return 4 * (N * P + Q * P + 2 * Q * (N + 1) + Q * Q + 4 * Q)


def _check(x, dt, Bm, Cm, a) -> None:
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3 or a.dim() != 1:
        raise ValueError("ssd: x must be [B,S,H,P], dt [B,S,H], Bm and Cm [B,S,N], a [H]")
    B, S, H, P = x.shape
    if dt.shape != (B, S, H) or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape \
            or a.shape != (H,):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, a {tuple(a.shape)} "
                         "do not agree")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd: x, Bm and Cm must share one dtype of {_DTYPES}, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd: dt and a must be float32, got {dt.dtype}, {a.dtype}")
    if any(t.device != x.device for t in (dt, Bm, Cm, a)):
        raise ValueError("ssd: all inputs must be on one device")


def route(x, Bm) -> str:
    """The kernel that ``ssd`` launches for x [B,S,H,P] and Bm [B,S,N] on
    CUDA, from dtype and shape alone: ``"sm90"`` for bf16 with N = P = 64,
    ``"scalar"`` for everything else."""
    if x.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16 \
            and x.shape[-1] in SM90_DIMS and Bm.shape[-1] == x.shape[-1]:
        return "sm90"
    return "scalar"


def ssd_plain(x, dt, Bm, Cm, a, chunk: int = 128,
              decay_dtype: torch.dtype = torch.float32):
    """The plain version of the route that the inputs take, with either
    decay: the sm90 route splits its fp32 operands into two bf16 terms, the
    scalar route keeps them fp32."""
    return ssd_scan_torch(x, dt, Bm, Cm, a, chunk, decay_dtype=decay_dtype,
                          **PLAIN_ARGS[route(x, Bm)])


def copy_check(x, Bm, Cm) -> None:
    """Raise ``ValueError`` unless x, Bm and Cm meet the sm90 kernel's 16-byte
    copies: base addresses 16-byte aligned, the last dim contiguous and every
    other stride a multiple of 8 elements (16 bytes of bf16).  Reads pointers
    and strides only, so it runs on any device."""
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd sm90: {name}'s base address is not 16-byte aligned "
                             f"(offset {t.data_ptr() % 16})")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd sm90: the last dim of {name} must be contiguous")
        for dim in range(t.dim() - 1):
            if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
                raise ValueError(f"ssd sm90: {name}'s stride {t.stride(dim)} of dim {dim} "
                                 f"is not a multiple of 16 bytes")


def _chunk(chunk: int, S: int) -> int:
    Q = min(chunk, S)
    if Q < 1 or Q > MAX_CHUNK:
        raise ValueError(f"ssd: chunk {Q} is outside the kernel's [1, {MAX_CHUNK}]")
    return Q


def _bf16_decay(decay_dtype) -> int:
    """The kernels' decay flag: 1 for a bf16 decay, 0 for fp32."""
    if decay_dtype not in DECAY_DTYPES:
        raise ValueError(f"ssd: decay_dtype {decay_dtype}: the kernels take one of "
                         f"{DECAY_DTYPES}")
    return int(decay_dtype == torch.bfloat16)


def ssd_sm90(x, dt, Bm, Cm, a, chunk: int = 128,
             decay_dtype: torch.dtype = torch.float32):
    """Launch csrc/ssd_scan_sm90.cu on CUDA tensors that take the sm90 route
    and meet ``copy_check``; raise ``ValueError`` otherwise.  Three kernels
    on the current stream: each chunk's state contribution into a scratch
    [B, nc, H, N, P] fp32, the pass across chunks that turns it into each
    chunk's incoming state (and the final state), then y."""
    global launches, launches_sm90
    _check(x, dt, Bm, Cm, a)
    if x.device.type != "cuda":
        raise ValueError(f"ssd sm90: no kernel for device {x.device}")
    if route(x, Bm) != "sm90":
        raise ValueError(f"ssd sm90: takes bf16 with N = P in {SM90_DIMS}, not "
                         f"{x.dtype} with P {x.shape[-1]}, N {Bm.shape[-1]}")
    flag = _bf16_decay(decay_dtype)
    copy_check(x, Bm, Cm)
    if not a.is_contiguous():
        raise ValueError("ssd sm90: a must be contiguous")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = _chunk(chunk, S)
    nc = -(-S // Q)
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    scratch = torch.empty(B, nc, H, N, P, dtype=torch.float32, device=x.device)
    decay = torch.empty(B, nc, H, dtype=torch.float32, device=x.device)
    lib = _cuda.library("ssd_scan_sm90")
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_sm90_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(), decay.data_ptr(),
            B, S, H, Q, x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), flag,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "ssd_scan_sm90")
    launches += 1
    launches_sm90 += 1
    return y, state


def ssd_scalar(x, dt, Bm, Cm, a, chunk: int = 128,
               decay_dtype: torch.dtype = torch.float32):
    """Launch csrc/ssd_scan.cu on CUDA tensors of either dtype."""
    global launches, launches_scalar
    _check(x, dt, Bm, Cm, a)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    flag = _bf16_decay(decay_dtype)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = _chunk(chunk, S)
    if smem_bytes(Q, N, P) > SMEM_LIMIT:
        raise ValueError(f"ssd: chunk {Q}, N {N}, P {P} need {smem_bytes(Q, N, P)} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a block has")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 or not a.is_contiguous():
        raise ValueError("ssd: the last dim of x, Bm and Cm, and a, must be contiguous")
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    lib = _cuda.library("ssd_scan")
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N, Q,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            int(x.dtype == torch.bfloat16), flag, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "ssd_scan")
    launches += 1
    launches_scalar += 1
    return y, state


class SSDFn(torch.autograd.Function):
    """``kernel(x, dt, Bm, Cm, a, chunk, decay_dtype)`` forward, plain torch
    backward: ``ssd_scan_torch`` recomputed from the saved inputs.
    ``kernel`` is an argument, so a CPU test can pass a plain version."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, a, chunk, decay_dtype, kernel):
        ctx.save_for_backward(x, dt, Bm, Cm, a)
        ctx.chunk, ctx.decay_dtype = chunk, decay_dtype
        ctx.set_materialize_grads(False)     # an unused output's gradient stays None
        return kernel(x, dt, Bm, Cm, a, chunk, decay_dtype)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        global backward_calls
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            outs = ssd_scan_torch(*inputs, ctx.chunk, decay_dtype=ctx.decay_dtype)
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_state)) if g is not None]
            grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                             [t for t in inputs if t.requires_grad],
                                             [g for _, g in pairs], allow_unused=True))
        backward_calls += 1
        return (*(next(grads) if n else None for n in need), None, None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        a: torch.Tensor, chunk: int = 128, decay_dtype: torch.dtype = torch.float32):
    """x [B,S,H,P], dt [B,S,H], Bm/Cm [B,S,N] (shared across heads), a [H]
    → (y [B,S,H,P] in x's dtype, state [B,H,N,P] fp32), in chunks of
    min(chunk, S) steps.  ``decay_dtype`` (fp32 or bf16, both kernels) is
    the type of the intra-chunk decay (see ``ssd_scan_torch``).
    Differentiable: on the card through ``SSDFn``, on the CPU as plain
    torch.  On DTensors, per rank on the local shards (``kernels._mesh``)."""
    if _mesh.is_dtensor(x):
        return _ssd_on_mesh(x, dt, Bm, Cm, a, chunk, decay_dtype)
    _check(x, dt, Bm, Cm, a)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, Bm, Cm, a, chunk, decay_dtype=decay_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    kernel = ssd_sm90 if route(x, Bm) == "sm90" else ssd_scalar
    return SSDFn.apply(x, dt, Bm, Cm, a, chunk, decay_dtype, kernel)


def _ssd_on_mesh(x, dt, Bm, Cm, a, chunk, decay_dtype):
    from torch.distributed.tensor import Partial, Replicate, Shard

    _check(x, dt, Bm, Cm, a)
    base = _mesh.base_placements(x, "ssd")
    # B and C are shared by the heads, a by the batch: whole where those
    # are split, and their gradients partial there
    shared = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in base)
    heads = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in base)
    shared_grad = tuple(Partial() if p.is_shard(2) else s for p, s in zip(base, shared))
    heads_grad = tuple(Partial() if p.is_shard(0) else h for p, h in zip(base, heads))
    state = tuple(Shard(1) if p.is_shard(2) else p for p in base)
    return _mesh.run(lambda *t: ssd(*t, chunk, decay_dtype=decay_dtype),
                     (x, dt, Bm, Cm, a), (base, base, shared, shared, heads),
                     (list(base), list(state)), x.device_mesh,
                     (base, base, shared_grad, shared_grad, heads_grad))
