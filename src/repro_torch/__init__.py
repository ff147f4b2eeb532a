"""FLoCoRA in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``repro`` (the reference, which it never
imports). Subpackages mirror the reference's layout: ``kernels/``,
``core/``, ``models/``, ``optim/``, ``fl/``, ``data/``, ``utils/``;
``convert.py`` carries a JAX-initialized parameter tree across.
"""
