"""Kernels (csrc/flash_attention_sm90.cu via kernels/flash_attention/ops.py):
the profiled slice's K2 calls, each call's bound (benchlib/counts.py: bytes
at the HBM rate against the causal pairs' operations at the dense bf16
rate) summed, over the summed device time of the kernels named in
KERNELS, in %."""
from benchlib.readers import roofline

KERNELS = ("flash_fwd_sm90",)


def read(run):
    return roofline(run, "k2", KERNELS, "bfloat16")
