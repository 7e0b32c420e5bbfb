"""PyTorch / CUDA port of the DiSketch system for NVIDIA Hopper (H100).

The package mirrors ``src/repro/`` (``core/``, ``kernels/``, ``net/``) so
each module's counterpart is easy to find.  It imports neither ``jax`` nor
``repro``; the JAX package is the reference it is tested against.

Entry points run on ``cuda`` by default and raise when no card is
present; the CPU (each kernel's plain PyTorch version) runs only when a
caller passes ``device="cpu"`` or hands a wrapper CPU tensors.
"""
