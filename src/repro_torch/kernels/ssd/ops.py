"""Wrappers of the two SSD scan kernels.

``ssd`` keeps the model's [B,S,H,P] layout at its interface, with B and C
shared across heads as [B,S,N], or in G groups as [B,S,G,N], head h reading
group h // (H/G) (Mamba2's ``n_groups``; [B,S,N] is G = 1).  On CUDA tensors
it launches one of two hand-written kernels, which ``route`` picks from dtype
and shape alone, before any launch:

- ``"sm90"`` (``csrc/ssd_scan_sm90.cu``): bf16 x, B and C with P = 64 and
  N = 64 (every Mamba2 prefill layer of zamba2-1.2b) or N = 128 (Nemotron-H's,
  G = 8), H/G a multiple of 8 where G > 1.  mma.sync bf16 tensor cores,
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

``ssd_step`` is the decode step's single-step recurrence on the fp32
state [B,H,N,P], in place, B and C [B,N] or in groups [B,G,N]: on CUDA tensors it launches
``csrc/ssd_step.cu``, which reads and writes each state element once
(``step_launches`` counts its calls); on CPU tensors it runs
``ssd_step_plain``.  On DTensors each rank runs the same on its local
shards, in place: the state's own batch or heads split, which x, dt, B and
C follow on the batch and a and d_skip on the heads.
"""
from __future__ import annotations

import functools

import torch

from .. import _cuda, _mesh
from .ref import ssd_scan_torch

launches = 0
launches_sm90 = 0
launches_scalar = 0
backward_calls = 0
step_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
DECAY_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448    # bytes of shared memory a block may opt into on sm_90
MAX_CHUNK = 128         # the kernels' tiles hold at most 128 steps
SM90_P = 64             # P of the sm90 route
SM90_N = (64, 128)      # its N, a template instance each
SM90_HEADS = 8          # heads a block of the sm90 route: H/G a multiple where G > 1
# each route's plain version: the arguments of ssd_scan_torch
PLAIN_ARGS = {"sm90": {"split": True}, "scalar": {}}
STEP_THREADS = 256      # at most, a block of ssd_step.cu
STEP_ROWS = 4           # state rows a thread of ssd_step.cu holds in flight


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block of the scalar kernel, as
    ``ssd_scan.cu`` lays it out: the [N,P] state, the x tile, the B and C
    tiles (rows padded by one), the [Q,Q] mixing tile and four per-step
    vectors, all fp32."""
    return 4 * (N * P + Q * P + 2 * Q * (N + 1) + Q * Q + 4 * Q)


def groups(Bm) -> int:
    """G of the scan's B or C: [B,S,G,N]; 1 for the shared [B,S,N]."""
    return Bm.shape[2] if Bm.dim() == 4 else 1


def _grouped(Bm):
    """B or C as [B,S,G,N] (a view; G = 1 for [B,S,N])."""
    return Bm if Bm.dim() == 4 else Bm[:, :, None, :]


def _check(x, dt, Bm, Cm, a) -> None:
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() not in (3, 4) or Cm.dim() != Bm.dim() \
            or a.dim() != 1:
        raise ValueError("ssd: x must be [B,S,H,P], dt [B,S,H], Bm and Cm [B,S,N] or "
                         "[B,S,G,N], a [H]")
    B, S, H, P = x.shape
    if dt.shape != (B, S, H) or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape \
            or a.shape != (H,) or H % groups(Bm):
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
    """The kernel that ``ssd`` launches for x [B,S,H,P] and Bm [B,S,N] or
    [B,S,G,N] on CUDA, from dtype and shape alone: ``"sm90"`` for bf16 with
    P = 64 and N in ``SM90_N``, its G groups each of a multiple of
    ``SM90_HEADS`` heads where G > 1; ``"scalar"`` for everything else."""
    G = groups(Bm)
    if x.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16 \
            and x.shape[-1] == SM90_P and Bm.shape[-1] in SM90_N \
            and (G == 1 or x.shape[2] // G % SM90_HEADS == 0):
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
        raise ValueError(f"ssd sm90: takes bf16 with P {SM90_P}, N in {SM90_N} and groups "
                         f"of a multiple of {SM90_HEADS} heads, not {x.dtype} with P "
                         f"{x.shape[-1]}, N {Bm.shape[-1]}, {x.shape[2]} heads in "
                         f"{groups(Bm)} groups")
    flag = _bf16_decay(decay_dtype)
    copy_check(x, Bm, Cm)
    if not a.is_contiguous():
        raise ValueError("ssd sm90: a must be contiguous")
    B, S, H, P = x.shape
    N, G = Bm.shape[-1], groups(Bm)
    Bg, Cg = _grouped(Bm), _grouped(Cm)
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
            B, S, H, N, G, Q, x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), *Bg.stride()[:3], *Cg.stride()[:3],
            flag, torch.cuda.current_stream().cuda_stream)
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
    N, G = Bm.shape[-1], groups(Bm)
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    Q = _chunk(chunk, S)
    if smem_bytes(Q, N, P) > SMEM_LIMIT:
        raise ValueError(f"ssd: chunk {Q}, N {N}, P {P} need {smem_bytes(Q, N, P)} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a block has")
    if x.stride(3) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1 or not a.is_contiguous():
        raise ValueError("ssd: the last dim of x, Bm and Cm, and a, must be contiguous")
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    lib = _cuda.library("ssd_scan")
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N, G, Q,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), *Bg.stride()[:3], *Cg.stride()[:3],
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
    """x [B,S,H,P], dt [B,S,H], Bm/Cm [B,S,N] (shared across heads) or
    [B,S,G,N] (head h reads group h // (H/G)), a [H]
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
    if groups(Bm) > 1 and any(p.is_shard(2) for p in base):
        raise ValueError("ssd on a mesh: B and C in groups take the heads whole")
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


# ------------------------------------------------------------ decode step ----
def _step_check(state, x, dt, a, Bm, Cm, d_skip) -> None:
    if state.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or a.dim() != 1 \
            or Bm.dim() not in (2, 3) or Cm.dim() != Bm.dim() or d_skip.dim() != 1:
        raise ValueError("ssd_step: state must be [B,H,N,P], x [B,H,P], dt [B,H], a and "
                         "d_skip [H], Bm and Cm [B,N] or [B,G,N]")
    B, H, N, P = state.shape
    G = _step_groups(Bm)
    if x.shape != (B, H, P) or dt.shape != (B, H) or a.shape != (H,) or H % G \
            or Bm.shape != (B, *Bm.shape[1:-1], N) or Cm.shape != Bm.shape \
            or d_skip.shape != (H,):
        raise ValueError(f"ssd_step: shapes state {tuple(state.shape)}, x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}, d_skip {tuple(d_skip.shape)} do not agree")
    if P % 4 or P > 4 * STEP_THREADS:
        raise ValueError(f"ssd_step: P {P}: the kernel takes P a multiple of 4, at most "
                         f"{4 * STEP_THREADS}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_step: x must be one of {_DTYPES}, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (state, dt, a, Bm, Cm)):
        raise ValueError("ssd_step: state, dt, a, Bm and Cm must be float32")
    if any(t.device != state.device for t in (x, dt, a, Bm, Cm, d_skip)):
        raise ValueError("ssd_step: all inputs must be on one device")


def _step_groups(Bm) -> int:
    """G of the step's B or C: [B,G,N]; 1 for the shared [B,N]."""
    return Bm.shape[1] if Bm.dim() == 3 else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def step_tile(B: int, H: int, N: int, P: int, sms: int):
    """(split, tn) of ``csrc/ssd_step.cu`` for a [B,H,N,P] state: P is
    split between ``split`` blocks until B·H·split fills ``sms`` SMs four
    blocks deep (or a slice is 4 columns wide); ``tn`` threads split N, so a
    thread holds at most ``STEP_ROWS`` rows."""
    split = 1
    while B * H * split < 4 * sms and P // split % 8 == 0:
        split *= 2
    tp = P // split // 4
    return split, max(1, min(-(-N // STEP_ROWS), STEP_THREADS // tp))


def ssd_step_plain(state, x, dt, a, Bm, Cm, d_skip):
    """The step in tensor ops: the same function as ``ssd_step``, writing
    the new state into ``state``.  Grouped B and C [B,G,N] are repeated to
    the heads, [B,H,N]."""
    xh = x.float()
    decay = torch.exp(dt * a)[:, :, None, None]
    state.mul_(decay)
    if Bm.dim() == 3:
        hpg = state.shape[1] // Bm.shape[1]
        Bh, Ch = Bm.repeat_interleave(hpg, dim=1), Cm.repeat_interleave(hpg, dim=1)
        state.add_(torch.einsum("bhn,bhp->bhnp", Bh, dt[:, :, None] * xh))
        y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    else:
        inflow = torch.einsum("bn,bhp->bhnp", Bm, dt[:, :, None] * xh)
        state.add_(inflow)
        y = torch.einsum("bn,bhnp->bhp", Cm, state)
    y = y + xh * d_skip.float()[None, :, None]
    return y.to(x.dtype)


def _ssd_step_cuda(state, x, dt, a, Bm, Cm, d_skip):
    global step_launches
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("ssd_step: the state must be contiguous and 16-byte aligned")
    if not a.is_contiguous():
        raise ValueError("ssd_step: a must be contiguous")
    d_skip = d_skip.float().contiguous()
    B, H, N, P = state.shape
    G = _step_groups(Bm)
    if Bm.dim() == 2:
        Bm, Cm = Bm[:, None, :], Cm[:, None, :]
    split, tn = step_tile(B, H, N, P, _sm_count(state.device))
    y = torch.empty(B, H, P, dtype=x.dtype, device=state.device)
    lib = _cuda.library("ssd_step")
    with torch.cuda.device(state.device):
        err = lib.ssd_step_launch(
            state.data_ptr(), x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), d_skip.data_ptr(), y.data_ptr(), B, H, N, P, G, split, tn,
            *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "ssd_step")
    step_launches += 1
    return y


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, d_skip: torch.Tensor) -> torch.Tensor:
    """One step of the recurrence: state [B,H,N,P] fp32, updated in place to
    exp(dt·a)·state + Bm ⊗ (dt·x); → y [B,H,P] in x's dtype, Cm·state + d_skip·x.
    x [B,H,P] is fp32 or bf16, d_skip [H] of any float dtype; dt [B,H], a [H],
    Bm and Cm [B,N] (shared) or [B,G,N] (head h reads group h // (H/G)) are
    fp32.  The kernel on CUDA tensors (no fallback),
    ``ssd_step_plain`` on CPU tensors; on DTensors, either on the local
    shards.  A shape the kernel does not take raises ``ValueError`` on
    every device."""
    if _mesh.is_dtensor(state):
        return _ssd_step_on_mesh(state, x, dt, a, Bm, Cm, d_skip)
    _step_check(state, x, dt, a, Bm, Cm, d_skip)
    if state.device.type == "cpu":
        return ssd_step_plain(state, x, dt, a, Bm, Cm, d_skip)
    if state.device.type != "cuda":
        raise ValueError(f"ssd_step: no kernel for device {state.device}")
    return _ssd_step_cuda(state, x, dt, a, Bm, Cm, d_skip)


def _ssd_step_on_mesh(state, x, dt, a, Bm, Cm, d_skip):
    """``ssd_step`` on each rank's local shards of the state as it is split:
    every (b, h) is its own recurrence, so nothing is summed across ranks.
    The state is never redistributed, as its update is in place; the other
    inputs are, to its split."""
    from torch.distributed.tensor import Replicate, Shard

    st = tuple(state.placements)
    if not all(p.is_replicate() or p.is_shard(0) or p.is_shard(1) for p in st):
        raise ValueError(f"ssd_step on a mesh: state placements {st}; the step takes "
                         f"batch (dim 0) and heads (dim 1) split, the rest whole")
    if _step_groups(Bm) > 1 and any(p.is_shard(1) for p in st):
        raise ValueError("ssd_step on a mesh: B and C in groups take the heads whole")
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in st)
    heads = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in st)
    return _mesh.run(ssd_step, (state, x, dt, a, Bm, Cm, d_skip),
                     (st, st, st, heads, rows, rows, heads), [*st], state.device_mesh)
