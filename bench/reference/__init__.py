"""The plain fp32 references, one file a model family (``<family>.py``),
with ``logits(weights, conf, tokens, S, out_positions, prec)``.  They import
neither JAX nor anything of the program."""
