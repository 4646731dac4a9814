"""The plain reference against the port's own path at a small size on the
CPU, both in fp32: a left-padded batch's prefill and greedy decode steps
through the port's caches give the logits the reference gives over the
prompts and the served tokens."""
import pytest
import torch

from benchlib import smoke, weights
from reference import hybrid


def served(model, prompts, steps):
    """Greedy serving as the engine does it: left-pad with 0, prefill, then
    ``steps`` decode steps → (padded S, tokens [B, steps + 1], logits
    [B, steps + 1, V] of every served token)."""
    S = max(map(len, prompts))
    toks = torch.tensor([[0] * (S - len(p)) + p for p in prompts])
    lg, cache = model.prefill({"tokens": toks}, max_len=S + steps + 1)
    outs, logits = [lg.argmax(-1)], [lg]
    for _ in range(steps):
        lg, cache = model.decode(cache, {"tokens": outs[-1][:, None]})
        outs.append(lg.argmax(-1))
        logits.append(lg)
    return S, torch.stack(outs, 1), torch.stack(logits, 1)


@pytest.mark.parametrize("lengths", [(7, 19, 12, 3), (40, 1, 33, 17)])
def test_reference_matches_the_port_in_fp32(lengths):
    conf = smoke.config("hybrid")
    model, w = weights.build(conf, 2**31 + 3, "cpu")
    model.cfg.dtype = torch.float32
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, conf["vocab_size"], (n,), generator=g).tolist()
               for n in lengths]
    S, got, port = served(model, prompts, 4)
    seqs = torch.cat([torch.tensor([[0] * (S - len(p)) + p for p in prompts]), got[:, :-1]], 1)
    ref = hybrid.logits(w, conf, seqs, S, list(range(S - 1, S + 4)))
    scale = ref.abs().max().item()
    assert (ref - port).abs().max().item() <= 2e-4 * (1 + scale)
    assert torch.equal(ref.argmax(-1), got)


def test_fp8_rounds_coarser_than_bf16():
    from reference.common import q8

    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(1))
    e8 = (q8(x, -1) - x).abs().max().item()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max().item()
    assert e8 > 4 * e16
