"""FLARE in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch port of the JAX package ``repro``: the module tree mirrors
``src/repro/`` so each port module has one reference file at the same path.
It imports ``torch`` and nothing of JAX or of ``repro``. Entry points run on
``device="cuda"`` unless the caller asks for the CPU; functions on tensors
follow the tensor's device. On a CUDA tensor a kernel wrapper launches its
kernel (built from ``csrc/`` at first use); on a CPU tensor it runs the
kernel's plain PyTorch version.
"""
