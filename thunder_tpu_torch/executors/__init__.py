"""Executors: the torch operator executor, the python executor, and the
hand-written CUDA kernel executors (flash, fused)."""
