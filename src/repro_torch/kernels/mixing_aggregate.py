"""CUDA wrapper of the Y_l = W Θ_l kernel (``csrc/mixing_aggregate.cu``).

Counterpart of `repro/kernels/mixing_aggregate.py` (the Pallas kernel).
`mixing_aggregate_leaves_cuda` mixes a list of leaves in one launch per
``N_MAX`` leaves: it checks what the kernel takes, builds the leaf table
(`launch_groups`, `copy_width`), allocates every output as a view of one
buffer and launches on PyTorch's current stream; it raises on anything
else.  Callers go through `kernels.ops.mixing_aggregate_leaves` (or
`mixing_aggregate`, its one-leaf case), which picks this for CUDA tensors
and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use
N_MAX = 32                   # leaves a launch takes (kMaxLeaves in the .cu)
TILE = 128                   # Θ columns a block owns (kTile)
ROWS_PER_BLOCK = 128         # output rows a block computes (kRowsPerBlock)
M_FULL, M_RING = 64, 16      # panel staged whole up to m = 64, else 2 × 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("mixing_aggregate")
    if not _bound:
        p = ctypes.c_void_p
        lib.repro_mix_leaves.argtypes = [
            p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p,
            ctypes.c_int, p]
        lib.repro_mix_leaves.restype = ctypes.c_int
        _bound = True
    return lib


def smem_bytes(k: int, m: int, elt: int) -> int:
    """Shared memory of one block (``repro_mix_smem`` in the .cu): W as
    (m, 4·KC + 4) floats, KC the rows a warp owns rounded up to 4, plus
    the Θ panel (m rows, or a 2 × 16-row ring above m = 64)."""
    nr = -(-min(k, ROWS_PER_BLOCK) // 4)
    kc = -(-nr // 4) * 4
    rows = m if m <= M_FULL else 2 * M_RING
    return 4 * m * (4 * kc + 4) + rows * TILE * elt


def copy_width(ptr: int, d: int, elt: int) -> int:
    """Bytes of the widest cp.async (16, 8 or 4) that every row of an
    (m, d) leaf at address ``ptr`` allows; 2 (plain loads) for a bf16 row
    that is 2-byte aligned only."""
    for w in (16, 8, 4):
        if ptr % w == 0 and (d * elt) % w == 0:
            return w
    return 2


def launch_groups(widths: Sequence[int]) -> List[Tuple[List[int], List[int]]]:
    """The launches of one call: ``[(leaf indices, tile prefix), ...]``,
    N_MAX leaves at most each, leaf l of a launch owning tiles
    [prefix[i], prefix[i + 1]) of TILE columns."""
    groups = []
    for s in range(0, len(widths), N_MAX):
        idx = list(range(s, min(s + N_MAX, len(widths))))
        prefix = [0]
        for i in idx:
            prefix.append(prefix[-1] + -(-widths[i] // TILE))
        groups.append((idx, prefix))
    return groups


def _check(w: torch.Tensor, thetas: Sequence[torch.Tensor]):
    if not thetas:
        raise ValueError("mixing_aggregate_leaves_cuda needs at least one leaf")
    if w.dim() != 2 or not w.is_cuda:
        raise ValueError(f"w must be a 2-D CUDA tensor, got {w.device} "
                         f"{tuple(w.shape)}")
    k, m = w.shape
    dtype = thetas[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"theta dtype {dtype} not supported (float32 or "
                        "bfloat16)")
    for t in thetas:
        if t.device != w.device:
            raise ValueError(f"mixing_aggregate_leaves_cuda needs w and every "
                             f"leaf on one CUDA device, got {w.device} and "
                             f"{t.device}")
        if t.dtype != dtype:
            raise TypeError(f"leaves of one call share a dtype: {dtype} and "
                            f"{t.dtype}")
        if t.dim() != 2 or t.shape[0] != m:
            raise ValueError(f"shapes w {tuple(w.shape)} x theta "
                             f"{tuple(t.shape)} do not contract")
        if not t.is_contiguous():
            raise ValueError("theta must be contiguous")
        if not 1 <= t.shape[1] < 2 ** 31:
            raise ValueError(f"leaf width {t.shape[1]} out of range")
    if k < 1 or m < 1:
        raise ValueError(f"empty shape k={k}, m={m}")
    smem = smem_bytes(k, m, thetas[0].element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"W ({k}x{m}) needs {smem} B of shared memory, "
                         f"above the {SMEM_LIMIT} B a block can use")


def mixing_aggregate_leaves_cuda(w: torch.Tensor,
                                 thetas: Sequence[torch.Tensor]
                                 ) -> List[torch.Tensor]:
    """[W Θ_l for each leaf] on the card: w (k, m) any float dtype (used as
    fp32), thetas (m, D_l) contiguous CUDA tensors of one dtype (fp32 or
    bf16) -> (k, D_l) each in that dtype, views of one buffer (each leaf's
    view contiguous and 16-byte aligned, no two overlapping)."""
    _check(w, thetas)
    k, m = w.shape
    dtype, elt = thetas[0].dtype, thetas[0].element_size()
    widths = [t.shape[1] for t in thetas]
    align = 16 // elt
    offsets, total = [], 0
    for d in widths:
        offsets.append(total)
        total += -(-k * d // align) * align
    buf = torch.empty(total, dtype=dtype, device=w.device)
    outs = [buf.as_strided((k, d), (d, 1), o) for o, d in zip(offsets, widths)]
    wf = w.to(torch.float32).contiguous()
    lib = _lib()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    for idx, prefix in launch_groups(widths):
        n = len(idx)
        th = (ctypes.c_void_p * n)(*(thetas[i].data_ptr() for i in idx))
        ou = (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in idx))
        ds = (ctypes.c_int * n)(*(widths[i] for i in idx))
        t0 = (ctypes.c_int * (n + 1))(*prefix)
        ld = (ctypes.c_ubyte * n)(*(copy_width(thetas[i].data_ptr(),
                                               widths[i], elt) for i in idx))
        with torch.cuda.device(w.device):
            err = lib.repro_mix_leaves(wf.data_ptr(), k, m, n, th, ou, ds, t0,
                                       ld, _DTYPES[dtype], stream)
        _build.check(err, "mixing_aggregate")
    return outs

