"""Hand-written CUDA kernels (csrc/*.cu), their build (build.py) and their
wrappers, each beside its plain-torch version (vmem_gather.py,
score_update.py)."""
