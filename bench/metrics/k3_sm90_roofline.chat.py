"""Kernels (csrc/ssd_scan_sm90.cu via kernels/ssd/ops.py): the profiled
slice's K3 calls, each call's bound (benchlib/counts.py: bytes at the HBM
rate against operations at the dense TF32 rate, as chip_smoke bounds K3)
summed, over the summed device time of the kernels named in KERNELS, %."""
from benchlib.readers import roofline

KERNELS = ("ssd_sm90_chunk_state", "ssd_sm90_state_pass", "ssd_sm90_chunk_scan")


def read(run):
    return roofline(run, "k3", KERNELS, "tfloat32")
