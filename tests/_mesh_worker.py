"""One rank of the port's mesh tests: a gloo group of ``--world`` CPU
processes on a TCP store at ``--port``, a mesh of ``--shape`` over
("data", "model").  Rank 0 saves what it computed to ``--out``:

- ``train``: smoke llama3.2-3b in fp32 (parameters and activations), one
  train step on seeded tokens: the loss and every parameter after the
  step, whole;
- ``mamba``: one Mamba2 block of zamba2-1.2b's smoke widths in fp32, its
  SSM heads split over "model" (K3's mesh path): the output and the
  gradients of every parameter and of the input, whole;
- ``decode``: the same model served: a prefill of 8 tokens into a cache of
  16 split on its sequence ("seq_kv" → "model"), then one decode step: both
  logits, whole;
- ``moe``, ``mla_moe``, ``vlm``, ``xlstm``: smoke phi3.5-moe, deepseek-v2
  (both at capacity factor 1.0, so that slots are dropped), qwen2-vl-72b
  (with patch embeddings and M-RoPE positions) and xlstm-1.3b in fp32, one
  ``Model.loss`` forward and backward (remat on, as the
  trainer runs it): the loss, every parameter's gradient, whole, each
  MoE layer's ``Routing`` (every call of ``moe.route``, the recompute's
  too), whole, and the ``Routing`` of the last MoE layer's router for 64
  seeded tokens split on the batch, whole.

    python tests/_mesh_worker.py --rank R --world 4 --port P --shape 2,2 \\
        --what train --out out.pt
"""
import argparse
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import Resolver, activate, distribute_model  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

def config(arch="llama3.2-3b"):
    cfg = get_config(arch, smoke=True)
    cfg.dtype = torch.float32
    return cfg


def batch(cfg, B=4, S=16):
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def train(resolver=None):
    """One step → (loss, {name: parameter after the step})."""
    cfg = config()
    model = Model(cfg, device="cpu", seed=0).float()
    b = batch(cfg)
    if resolver is not None:
        distribute_model(model, resolver)
        b = {k: distribute_tensor(v, resolver.mesh, resolver(("batch", None), v.shape))
             for k, v in b.items()}
    opt = AdamW()
    step = make_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    if resolver is None:
        _, metrics = step(state, b)
    else:
        with activate(resolver):
            _, metrics = step(state, b)
    return (whole(metrics["loss"]).detach(),
            {k: whole(p).detach().clone() for k, p in model.named_parameters()})


def mamba(resolver=None):
    """One Mamba2 block forward and backward → (output, {name: gradient},
    the input's gradient)."""
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(0)
    block = ssm.Mamba2(g, 64, 128, 16, 16, device="cpu").float().requires_grad_(True)
    x = torch.randn(2, 32, 64, generator=g)
    grad_out = torch.randn(2, 32, 64, generator=g)
    if resolver is None:
        x.requires_grad_(True)
        out = ssm.mamba2_forward(block, x, 16)
        (out * grad_out).sum().backward()
        return out.detach(), {k: p.grad for k, p in block.named_parameters()}, x.grad
    distribute_model(block, resolver)
    whole_seq = resolver(("batch", "seq", None), x.shape)
    x = distribute_tensor(x, resolver.mesh, whole_seq).requires_grad_(True)
    grad_out = distribute_tensor(grad_out, resolver.mesh, whole_seq)
    with activate(resolver):
        out = ssm.mamba2_forward(block, x, 16)
        (out * grad_out).sum().backward()
    return (whole(out).detach(), {k: whole(p.grad) for k, p in block.named_parameters()},
            whole(x.grad))


def decode(resolver=None):
    """Prefill 8 tokens into a cache of 16, then one decode step → both
    logits."""
    cfg = config()
    model = Model(cfg, device="cpu", seed=0).float()
    b = {"tokens": batch(cfg, S=8)["tokens"]}
    nxt = {"tokens": b["tokens"][:, -1:]}
    if resolver is None:
        logits, cache = model.prefill(b, max_len=16)
        out, _ = model.decode(cache, nxt)
        return logits, out
    distribute_model(model, resolver)
    b, nxt = ({k: distribute_tensor(v, resolver.mesh, resolver(("batch", None), v.shape))
               for k, v in d.items()} for d in (b, nxt))
    with activate(resolver):
        logits, cache = model.prefill(b, max_len=16)
        out, _ = model.decode(cache, nxt)
    return whole(logits), whole(out)


FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "mla_moe": "deepseek-v2-236b",
            "vlm": "qwen2-vl-72b", "xlstm": "xlstm-1.3b"}


def family_batch(cfg, B=4, S=16):
    b = batch(cfg, B, S)
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(8)
        P = cfg.n_patches
        b["patch_embeds"] = torch.randn(B, P, cfg.d_model, generator=g)
        b["patch_positions"] = torch.stack([torch.randperm(S, generator=g)[:P]
                                            for _ in range(B)])
        t = torch.arange(S)
        b["positions3"] = torch.stack([t, t // 4, t % 4], -1)[None].expand(B, S, 3).contiguous()
    return b


def family(what, resolver=None):
    """One loss forward and backward → (loss, {name: gradient}, [routing])."""
    from repro_torch.models import moe

    cfg = config(FAMILIES[what])
    cfg.capacity_factor = 1.0       # capacity T·k/E: some slots are dropped
    model = Model(cfg, device="cpu", seed=0).float().requires_grad_(True)
    b = family_batch(cfg)
    routes, route = [], moe.route

    def spy(*args, **kw):
        r = route(*args, **kw)
        routes.append({"cap": r.cap, **{k: whole(getattr(r, k)).detach() for k in
                                        ("top_e", "kept", "where", "token_idx", "gate",
                                         "aux_loss")}})
        return r

    moe.route = spy
    direct = None
    if cfg.n_experts:
        # the routing alone, on the same tokens [B·S, D] split on the batch
        xf = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(9))
        layer = model.layers[-1].moe
        if resolver is not None:
            xf = distribute_tensor(xf, resolver.mesh, resolver(("batch", None), xf.shape))
            with activate(resolver):
                r = route(layer.router, xf, cfg.top_k, cfg.capacity_factor)
        else:
            r = route(layer.router, xf, cfg.top_k, cfg.capacity_factor)
        direct = {"cap": r.cap, **{k: whole(getattr(r, k)).detach() for k in
                                   ("top_e", "kept", "where", "token_idx", "gate", "aux_loss")}}
    try:
        if resolver is None:
            loss, _ = model.loss(b)
            loss.backward()
        else:
            distribute_model(model, resolver)
            b = {k: distribute_tensor(v, resolver.mesh,
                                      resolver(("batch",) + (None,) * (v.dim() - 1), v.shape))
                 for k, v in b.items()}
            with activate(resolver):
                loss, _ = model.loss(b)
                loss.backward()
    finally:
        moe.route = route
    return (whole(loss).detach(), {k: whole(p.grad) for k, p in model.named_parameters()},
            routes, direct)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--what", choices=("train", "mamba", "decode", *FAMILIES), required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=60))
    try:
        shape = tuple(int(n) for n in args.shape.split(","))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        if args.what == "train":
            out = train(Resolver(config(), mesh))
        elif args.what == "mamba":
            out = mamba(Resolver(config("zamba2-1.2b"), mesh))
        elif args.what in FAMILIES:
            out = family(args.what, Resolver(config(FAMILIES[args.what]), mesh))
        else:
            resolver = Resolver(config(), mesh, overrides={"seq_kv": ("model",)})
            out = decode(resolver)
        if args.rank == 0:
            torch.save(out, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
