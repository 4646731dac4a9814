"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

``event_join`` replaces the Pallas kernel ``event_join_counts``,
``flash_attention`` replaces ``flash_attention_bhsd`` (with two kernels, one
for the bf16 route on the tensor cores and one for the rest) and ``ssd``
replaces ``ssd_scan``; the sources live in ``csrc/`` and are built at first
use (``kernels._cuda``).
"""
