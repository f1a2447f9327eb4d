"""dst-libp2p-test-node on PyTorch and CUDA: the port of dst_libp2p_test_node_tpu.

The JAX package beside this one is the reference; this package mirrors its
layout and names module by module and is held against it leaf by leaf in
tests/port/test_torch_*.py. It imports torch and never jax, and nothing of the
JAX package. Its entry points run on CUDA unless the caller passes
device="cpu" (--device cpu); on a CUDA tensor the hot gather and the
score-decay materialization run hand-written kernels (native/csrc/*.cu).
"""

__version__ = "0.1.0"
