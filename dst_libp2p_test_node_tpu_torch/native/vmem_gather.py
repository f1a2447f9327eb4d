"""The fixpoint's hot gather, out[..., q, j] = t[..., max(src[..., q, j], 0)].

Replaces the reference's Pallas kernel (dst_libp2p_test_node_tpu/native/
vmem_gather.py:87, `_compiled`'s pallas_call, entry `vmem_gather` :103),
reached from parallel/exchange._src_gather on every relaxation sweep of the
receiver-side fixpoint. On a CUDA tensor the wrapper launches the hand-
written kernel in csrc/vmem_gather.cu; on a CPU tensor it runs the plain
version, `vmem_gather_ref`. There is no probe and no switch: a CUDA call
that cannot build or launch the kernel raises.

Shapes: t (Nt,) or (B, Nt) float32; src (N, C) or (B, N, C) int32 with -1
pads. A (Nt,) t is shared across a batched src. Indices are clamped to
[0, Nt - 1] in both versions (pads read row 0, which the caller's validity
flags mask). The kernel streams src in with bulk copies, so on the card src
must start on a 16-byte boundary, as every fresh allocation does.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "vmem_gather"
# kernel launches since the last reset (chip_smoke.py zeroes it around the
# main path to show the path ran through the kernel)
launches = 0


def vmem_gather_ref(t_all: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain-torch version: the same clamp and gather."""
    idx = src.long().clamp(0, t_all.shape[-1] - 1)
    if t_all.dim() == 1:
        return t_all[idx]
    return torch.gather(t_all, 1, idx.reshape(idx.shape[0], -1)
                        ).reshape(idx.shape)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.vmem_gather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    return lib


def _check(t_all: torch.Tensor, src: torch.Tensor) -> None:
    if t_all.device != src.device:
        raise ValueError(f"t on {t_all.device}, src on {src.device}")
    if t_all.dtype != torch.float32 or src.dtype != torch.int32:
        raise TypeError(f"want float32 t and int32 src, got {t_all.dtype}, "
                        f"{src.dtype}")
    if t_all.dim() not in (1, 2) or src.dim() not in (2, 3):
        raise ValueError(f"bad ranks: t {tuple(t_all.shape)}, "
                         f"src {tuple(src.shape)}")
    if t_all.dim() == 2 and (src.dim() != 3
                             or src.shape[0] != t_all.shape[0]):
        raise ValueError("a batched t needs a src with the same batch")
    if not (t_all.is_contiguous() and src.is_contiguous()):
        raise ValueError("vmem_gather takes contiguous tensors")
    if t_all.shape[-1] == 0 and src.numel() > 0:
        raise ValueError("vmem_gather needs a non-empty t")


def vmem_gather(t_all: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Gather the sender time of every receiver slot (see module doc)."""
    _check(t_all, src)
    if src.device.type == "cpu":
        return vmem_gather_ref(t_all, src)
    if src.device.type != "cuda":
        raise ValueError(f"vmem_gather has no kernel for {src.device}")
    if src.data_ptr() % 16 != 0:
        raise ValueError("vmem_gather's kernel needs a 16-byte-aligned src "
                         "(a view at an offset: pass a copy)")
    global launches
    batch = src.shape[0] if src.dim() == 3 else 1
    n_src = t_all.shape[-1]
    out = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.vmem_gather_launch(
            t_all.data_ptr(), src.data_ptr(), out.data_ptr(), batch,
            src.numel() // batch, n_src, n_src if t_all.dim() == 2 else 0,
            torch.cuda.current_stream(src.device).cuda_stream)
    build.check_launch(lib, NAME, err)
    launches += 1
    return out
