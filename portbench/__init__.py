"""The benchmark of the PyTorch/CUDA port ``scfgp_tpu_torch`` (``python -m
portbench.run``; ``PERF.md`` at the root says what it measures).

Nothing here imports JAX or the JAX package.
"""
