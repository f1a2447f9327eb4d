"""Hand-written CUDA kernels (csrc/*.cu), their build (build.py) and their
wrappers, each beside its plain-torch version (vmem_gather.py,
score_update.py)."""


def launch_counts() -> dict:
    """Each kernel's launches since its counter was last zeroed (a fresh
    process starts at 0; a CPU tensor never counts)."""
    from . import score_update, vmem_gather

    return {"vmem_gather": vmem_gather.launches,
            "score_update": score_update.launches}
