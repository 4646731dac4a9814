"""PyTorch and CUDA port of the Triggerflow reproduction (``src/repro``).

Imports torch and numpy, never jax and never the ``repro`` package.  Layout
mirrors the reference: ``core``, ``bus``, ``chaos`` and ``obs`` (the
Triggerflow runtime, its sharded bus and its chaos harness),
``kernels`` (hand-written CUDA kernels for Hopper, sources in ``csrc``),
``models``, ``configs``, ``serving`` and ``launch``.
"""
