"""The benchmark's library: the harness behind ``bench/run.py``.

Nothing here imports the JAX package or JAX; the harness drives the
PyTorch port (``repro_torch``) from outside, and ``bench/reference/``
holds the plain fp32 models that judge it.
"""
