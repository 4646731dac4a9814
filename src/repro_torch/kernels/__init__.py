"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

``event_join`` replaces the Pallas kernel ``event_join_counts`` and
``flash_attention`` replaces ``flash_attention_bhsd``; the sources live in
``csrc/`` and are built at first use (``kernels._cuda``).
"""
