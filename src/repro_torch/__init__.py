"""PyTorch/CUDA port of the distributed graph-coloring system.

Mirrors the layout of ``repro`` (the JAX reference): ``graph/`` (CSR,
generators, partitioning — numpy, copied), ``core/`` (rules, local
coloring, backends, exchange, round loop, plans), ``kernels/`` (CUDA C++
kernels for Hopper with their plain-PyTorch versions), ``launch/`` (CLI).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
