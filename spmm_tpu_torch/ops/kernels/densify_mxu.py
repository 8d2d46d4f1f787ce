"""Canonical CSR -> dense (m, k) float32, each output byte written once.

Port of `spmm_tpu/ops/kernels/densify_mxu.py::csr_densify_mxu`, a lab
kernel that nothing else calls (as in the JAX package, where it lost to
`densify_onehot` on the TPU).  On a CUDA tensor the wrapper launches the
hand-written kernel of `csrc/densify_mxu.cu` (one CTA per 32-row stripe and
256-column tile: a shared tile zeroed, the entries scattered into it, the
tile written with 16-byte stores, so the output needs no memset); on a CPU
tensor it runs `csr_densify_mxu_plain`.  Both give `CSR.toarray()` bit for
bit.  Non-float32 data is densified in float32 and cast back, as JAX does.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_csr


def csr_densify_mxu_plain(indptr: torch.Tensor, indices: torch.Tensor,
                          data: torch.Tensor, m: int, k: int
                          ) -> torch.Tensor:
    """Plain PyTorch version, on any device."""
    return prim.csr_to_dense_canonical(indptr, indices, data.float(),
                                       (m, k)).to(data.dtype)


def _check_canonical(indptr, indices, m: int, k: int) -> None:
    """Raise unless the structure is canonical: indices within [0, k),
    strictly increasing within each row (one host sync)."""
    rows = prim.rows_from_indptr(indptr, indices.numel())
    bad = ~prim.is_sorted_canonical(rows, indices)
    if indices.numel():
        bad |= (indices.min() < 0) | (indices.max() >= k)
    if bool(bad):
        raise ValueError("csr_densify_mxu expects a canonical CSR (sorted, "
                         "duplicate-free column indices in [0, k)): call "
                         "sum_duplicates() first")


def csr_densify_mxu(indptr: torch.Tensor, indices: torch.Tensor,
                    data: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Dense (m, k) tensor of a canonical CSR, in data's dtype."""
    f32 = data.float().contiguous()
    check_csr(indptr, indices, f32, m, "csr_densify_mxu")
    _check_canonical(indptr, indices, m, k)
    if data.device.type == "cpu":
        return csr_densify_mxu_plain(indptr, indices, data, m, k)
    if data.numel() == 0 or m == 0 or k == 0:
        return torch.zeros((m, k), dtype=data.dtype, device=data.device)
    return _launch(indptr, indices, f32, m, k).to(data.dtype)


def _launch(indptr, indices, data, m: int, k: int) -> torch.Tensor:
    """The kernel alone on checked, canonical, non-empty float32 input."""
    out = torch.empty((m, k), dtype=torch.float32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        err = lib.spmm_densify_mxu(
            indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            out.data_ptr(), m, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "csr_densify_mxu")
    _build.LAUNCHES["csr_densify_mxu"] += 1
    return out
