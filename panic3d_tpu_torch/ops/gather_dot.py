"""Row gather followed by one dot: ``table[idx] @ w`` with f32 accumulation.

The counterpart of the repository's one Pallas kernel,
scripts/bench_pallas_gather.py:pallas_fused (:43, call :70): a probe that
gathers rows of a VMEM-resident [4096, 128] f32 table for 131,072 indices
and multiplies them by a [128, 64] weight, the computation at the heart of
the triplane decode (K1). Kernel K12 (csrc/gather_dot.cu) does it on the
card -- each table row times ``w`` once, then a gather of those products;
``gather_dot_plain`` is its plain version, which the wrapper takes only for
CPU tensors.
"""

from __future__ import annotations

import torch

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb

_K12_ARGS = (kb.PTR,) * 5 + (kb.INT,) * 4 + (kb.PTR,)


def gather_dot_plain(idx, table, w):
    """idx [P] int, table [R,K] f32, w [K,D] f32 -> [P,D] f32."""
    return table.index_select(0, idx.long()) @ w


def gather_dot_kernel(idx, table, w):
    """Launch K12 on CUDA tensors: same contract as gather_dot_plain."""
    require_no_grad("gather_dot", table, w)
    dev = table.device
    P, (R, K), D = idx.shape[0], table.shape, w.shape[1]
    if not (idx.dtype == torch.int32 and idx.ndim == 1 and idx.is_contiguous()
            and idx.device == dev):
        raise ValueError("K12 idx must be contiguous int32 [P] on the table's device")
    for t, name in ((table, "table"), (w, "w")):
        if not (t.dtype == torch.float32 and t.is_contiguous() and t.ndim == 2
                and t.device == dev):
            raise ValueError(f"K12 {name} must be contiguous f32 2-D on one device")
    if w.shape[0] != K or D % 4 or D == 0 or max(P, R) * D >= 2 ** 31:
        raise ValueError(f"K12 takes table [R,K] and w [K,D] with D a multiple of 4 and P*D, "
                         f"R*D < 2^31; got {tuple(table.shape)}, {tuple(w.shape)}, P={P}")
    prod = torch.empty((R, D), dtype=torch.float32, device=dev)   # table @ w, row by row
    out = torch.empty((P, D), dtype=torch.float32, device=dev)
    kb.launch("gather_dot", _K12_ARGS, idx.data_ptr(), table.data_ptr(),
              w.data_ptr(), prod.data_ptr(), out.data_ptr(), P, R, K, D,
              torch.cuda.current_stream(dev).cuda_stream)
    KERNELS["gather_dot"].launches += 1
    return out


def gather_dot(idx, table, w):
    if table.device.type == "cpu":
        return gather_dot_plain(idx, table, w)
    if table.device.type == "cuda":
        return gather_dot_kernel(idx, table, w)
    raise RuntimeError(f"gather_dot: no path for device {table.device}")
