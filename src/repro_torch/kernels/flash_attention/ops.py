"""Wrappers of the two flash attention kernels.

``flash_attention`` keeps the reference's [B,S,H,D] layout at its interface.
On CUDA tensors it launches one of two hand-written kernels, which ``route``
picks from dtype and shape alone, before any launch:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bf16 with (D, Dv) one of
  ``SM90_HEAD_DIM_PAIRS``, (64, 64), (128, 128) and (192, 128): the prefill
  attention of every served model, deepseek-v2's expanded MLA (D 192 =
  nope 128 + rope 64, Dv 128) included.  wgmma tensor cores and TMA loads;
  q, k and v must meet TMA's conditions (``tma_check``), or the wrapper
  raises ``ValueError``.
- ``"scalar"`` (``csrc/flash_attention.cu``): every other input (fp32, other
  pairs of head dims), on the CUDA cores.

No route falls back to another, and nothing falls back to the plain
version: a refused input or a failed launch raises.  On CPU tensors
``flash_attention`` runs the plain version of the route the inputs would
take on the card (``flash_attention_plain``).  ``launches`` counts the
launches of both kernels, ``launches_sm90`` and ``launches_scalar`` each
route's.

On the card the kernel runs inside ``FlashAttentionFn``, an autograd
Function: its forward is the route's kernel, its backward recomputes the
JAX package's ``attention_chunked`` in plain torch from the saved q, k, v
and backpropagates through it (the JAX package has no backward kernel; its
train step differentiates plain jnp).  ``backward_calls`` counts those
backward passes.  Without autograd (serving) the forward is the same one
launch.  On DTensors (the mesh path) each rank runs the route on its local
shards (``kernels._mesh``): batch and heads may be split, and k and v
follow q's heads, so kv heads must split as q's do.
"""
from __future__ import annotations

import math

import torch

from .. import _cuda, _mesh
from .ref import SM90_BLOCK_K, flash_attention_torch

launches = 0
launches_sm90 = 0
launches_scalar = 0
backward_calls = 0

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
SM90_HEAD_DIM_PAIRS = frozenset({(64, 64), (128, 128), (192, 128)})  # (D, Dv)
# each route's plain version: the arguments of flash_attention_torch
PLAIN_ARGS = {"sm90": {"p_split": True, "block_k": SM90_BLOCK_K},
              "scalar": {}}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be [B,S,H,D]")
    B, S, Hq, D = q.shape
    if k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3] or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads are not a multiple "
                         f"of {k.shape[2]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; all must be one of {_DTYPES}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")


def route(q, k, v) -> str:
    """The kernel that ``flash_attention`` launches for q, k, v on CUDA,
    from dtype and shape alone: ``"sm90"`` for bf16 with (D, Dv) in
    ``SM90_HEAD_DIM_PAIRS``, ``"scalar"`` for everything else."""
    if q.dtype == torch.bfloat16 and (q.shape[-1], v.shape[-1]) in SM90_HEAD_DIM_PAIRS:
        return "sm90"
    return "scalar"


def flash_attention_plain(q, k, v, causal: bool = True):
    """The plain version of the route that q, k, v take: the sm90 route
    splits p into two bf16 terms over kv tiles of 128, the scalar route
    keeps it fp32 over tiles of 32."""
    return flash_attention_torch(q, k, v, causal=causal, **PLAIN_ARGS[route(q, k, v)])


def _tma_strides(t) -> tuple:
    """t's element strides of B, S and H; a dim of size 1 takes the dense
    stride, since its own stride is never stepped."""
    strides = []
    dense = t.shape[3]
    for dim in (2, 1, 0):
        strides.append(t.stride(dim) if t.shape[dim] > 1 else dense)
        dense = strides[-1] * t.shape[dim]
    return tuple(reversed(strides))


def tma_check(q, k, v) -> None:
    """Raise ``ValueError`` unless q, k and v meet what the sm90 kernel's
    TMA loads need: base addresses 16-byte aligned, the last dim contiguous
    and the strides of B, S and H multiples of 16 bytes.  Reads pointers and
    strides only, so it runs on any device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention sm90: {name}'s base address is not "
                             f"16-byte aligned (offset {t.data_ptr() % 16})")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention sm90: the last dim of {name} must be "
                             f"contiguous")
        for dim, stride in zip("BSH", _tma_strides(t)):
            if stride * size % 16:
                raise ValueError(f"flash_attention sm90: {name}'s {dim} stride of "
                                 f"{stride * size} bytes is not a multiple of 16")


def flash_attention_sm90(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch csrc/flash_attention_sm90.cu on CUDA tensors that take the
    sm90 route and meet ``tma_check``; raise ``ValueError`` otherwise."""
    global launches, launches_sm90
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention sm90: no kernel for device {q.device}")
    if route(q, k, v) != "sm90":
        raise ValueError(f"flash_attention sm90: takes bf16 with (D, Dv) in "
                         f"{sorted(SM90_HEAD_DIM_PAIRS)}, not {q.dtype} with D {q.shape[3]}, "
                         f"Dv {v.shape[3]}")
    tma_check(q, k, v)
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    out = torch.empty(B, S, Hq, Dv, dtype=q.dtype, device=q.device)
    lib = _cuda.library("flash_attention_sm90")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, D, Dv, *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
            int(causal), 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "flash_attention_sm90")
    launches += 1
    launches_sm90 += 1
    return out


def flash_attention_scalar(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch csrc/flash_attention.cu on CUDA tensors of either dtype and
    head dims up to 256."""
    global launches, launches_scalar
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} exceed {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the last dim of q, k and v must be "
                         "contiguous")
    out = torch.empty(B, S, Hq, Dv, dtype=q.dtype, device=q.device)
    lib = _cuda.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, D, Dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "flash_attention")
    launches += 1
    launches_scalar += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``kernel(q, k, v, causal=causal)`` forward, plain torch backward:
    the JAX package's ``attention_chunked`` recomputed from the saved
    inputs.  ``kernel`` is an argument, so a CPU test can pass a plain
    version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kernel):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return kernel(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        global backward_calls
        from ...models.layers import attention_chunked

        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = attention_chunked(*inputs, causal=ctx.causal)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                             grad_out))
        backward_calls += 1
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,Hq,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv] → [B,S,Hq,Dv] in q's
    dtype; query head h reads kv head h // (Hq // Hkv).  Differentiable:
    on the card through ``FlashAttentionFn``, on the CPU as plain torch.
    On DTensors, per rank on the local shards (``kernels._mesh``)."""
    if _mesh.is_dtensor(q):
        return _flash_attention_on_mesh(q, k, v, causal)
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    kernel = flash_attention_sm90 if route(q, k, v) == "sm90" else flash_attention_scalar
    return FlashAttentionFn.apply(q, k, v, causal, kernel)


def _flash_attention_on_mesh(q, k, v, causal: bool):
    _check(q, k, v)
    placements = _mesh.base_placements(q, "flash_attention")
    n = _mesh.heads_split(q.device_mesh, placements)
    if k.shape[2] % n:
        raise ValueError(f"flash_attention on a mesh: {q.shape[2]} query heads split over "
                         f"{n} ranks, but k's {k.shape[2]} kv heads cannot follow them")
    return _mesh.run(lambda q, k, v: flash_attention(q, k, v, causal=causal), (q, k, v),
                     (placements,) * 3, list(placements), q.device_mesh)
