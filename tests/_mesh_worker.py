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
  logits, whole.

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--what", choices=("train", "mamba", "decode"), required=True)
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
        else:
            resolver = Resolver(config(), mesh, overrides={"seq_kv": ("model",)})
            out = decode(resolver)
        if args.rank == 0:
            torch.save(out, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
