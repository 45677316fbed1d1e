"""PyTorch/CUDA port of tpu-zkevm-harness (NVIDIA Hopper, `sm_90a`).

A second package beside `zkevm_harness_tpu`, with the same sub-packages and
module names so each counterpart is easy to find. It imports `torch` and
numpy only — never `jax`, and nothing of the JAX package.

Layout:
  ops/       Goldilocks field, hand-written CUDA kernels and their binding,
             Poseidon2, NTT/LDE, Merkle
  prover/    transcript, FRI, PLONKish prove + verify
  circuits/  the flagship circuit
  utils/     exact host ints, tracing spans, proof JSON
  csrc/      CUDA C++ sources, built with nvcc at first use on a CUDA tensor
  params/    the package's own copy of the Poseidon2 constants
  convert.py numpy bridges to and from the JAX package's data layout

A field element is one int64 holding the canonical u64 bit pattern. Every
entry point that allocates takes `device`: `None` means the CUDA card (and
raises where there is none), `"cpu"` runs the kernels' plain versions.
"""

__version__ = "0.1.0"
