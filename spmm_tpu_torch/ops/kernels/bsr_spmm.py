"""C = A_bsr @ B: block-sparse (BSR) times dense.

Port of `spmm_tpu/ops/kernels/bsr_spmm.py` (`bsr_spmm_pallas` and its eager
wrapper `spmm_bsr_pallas`, here `bsr_spmm` and `spmm_bsr`).  On a CUDA
tensor `bsr_spmm` launches the hand-written kernel of `csrc/bsr_spmm.cu`
(one CTA per block row, tile of B's columns and chunk of the block's rows,
the row's blocks walked in stored order, the sum kept in registers, each
product in 3xTF32 on the tensor cores: the Hopper form of the TPU kernel's
`precision=HIGHEST`); on a CPU tensor it runs `bsr_spmm_plain`.  The kernel
stages ragged K and N with zeros itself, so the wrapper pads nothing (the
TPU wrapper pads K to C and N to the tile, then cuts back).

The TPU kernel computes in its blocks' dtype (`out_shape` and
`preferred_element_type`).  On the card bfloat16, float64 and int32 launch
the same file's FMA kernel (`bsr_spmm_fma`): each block's product summed
in float32 for bfloat16 (else in the dtype itself), rounded to the dtype
and added to the running sum, as the TPU kernel's `out_ref +=` rounds it.
A complex dtype raises on every device, as the JAX kernel raises off the
TPU (Pallas has no complex scratch value); any other dtype raises on the
card.

`bsr_spmm_plain` is JAX's `_bsr_spmm` (`spmm_tpu/ops/spmm.py`, XLA's
`dot_general` and `segment_sum`, no Pallas): the B slab of every block
gathered, one `torch.bmm` in IEEE float32 (TF32 off), and each block row's
partial products summed in stored order by
`_primitives.segment_sum_inorder` (no atomics).  `spmm(via="bsr")` takes it
on every device, as JAX takes `_bsr_spmm`.  Its order of additions and its
products differ from the kernel's (cuBLAS's IEEE fp32 against split tf32
products), so the two agree within 1e-6 of each entry's absolute sum
(|A|·|B|)_ij, not bitwise.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.spgemm import _value_matmul

# the FMA kernel's type codes (float32 takes the tensor-core kernel)
_WIDE = {torch.bfloat16: 0, torch.float64: 1, torch.int32: 2}


def _check(indptr, indices, blocks, b, m: int) -> None:
    for name, t, dtype, dim in (("indptr", indptr, prim.INDEX_DTYPE, 1),
                                ("indices", indices, prim.INDEX_DTYPE, 1),
                                ("blocks", blocks, blocks.dtype, 3),
                                ("b", b, blocks.dtype, 2)):
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"bsr_spmm: {name} must be a contiguous {dim}-D "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != blocks.device:
            raise ValueError(f"bsr_spmm: {name} is on {t.device}, blocks on "
                             f"{blocks.device}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bsr_spmm: unsupported device {blocks.device}")
    mb = indptr.numel() - 1
    R = blocks.shape[1]
    if indices.numel() != blocks.shape[0]:
        raise ValueError("bsr_spmm: indices and blocks differ in length")
    if R == 0 or mb != -(-m // R):
        raise ValueError(f"bsr_spmm: {mb} block rows of {R} rows do not "
                         f"cover exactly {m} rows")


def bsr_spmm_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   blocks: torch.Tensor, b: torch.Tensor, m: int
                   ) -> torch.Tensor:
    """Plain PyTorch version, on any device: (m, N) = A_bsr @ b."""
    nblocks, R, C = blocks.shape
    mb = indptr.numel() - 1
    K, N = b.shape
    if nblocks == 0:
        return torch.zeros((m, N), dtype=blocks.dtype, device=blocks.device)
    pad = (-K) % C
    b_blocked = torch.nn.functional.pad(b, (0, 0, 0, pad)).view(-1, C, N)
    slabs = b_blocked[indices.long()]  # (nblocks, C, N)
    partial = _value_matmul(blocks, slabs)  # (nblocks, R, N)
    counts = indptr[1:] - indptr[:-1]
    sums = prim.segment_sum_inorder(partial.view(nblocks, R * N),
                                    indptr[:-1], counts)
    return sums.view(mb * R, N)[:m]


def bsr_spmm(indptr: torch.Tensor, indices: torch.Tensor,
             blocks: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """(m, N) = A_bsr @ b in the blocks' dtype, with A's block rows
    (indptr, mb + 1), block column ids (indices) and blocks (nblocks, R, C),
    and b (K, N) row-major of the same dtype; each output block row is the
    sum over its blocks, in stored order, of block @ b[bcol*C:(bcol+1)*C]."""
    _check(indptr, indices, blocks, b, m)
    dtype = blocks.dtype
    if dtype.is_complex:
        raise NotImplementedError(f"bsr_spmm of {dtype}: the JAX kernel "
                                  "takes no complex dtype; use via='bsr'")
    if blocks.device.type == "cpu":
        return bsr_spmm_plain(indptr, indices, blocks, b, m)
    if dtype != torch.float32 and dtype not in _WIDE:
        raise NotImplementedError(f"bsr_spmm of {dtype} on a CUDA device")
    nblocks, R, C = blocks.shape
    K, N = b.shape
    if nblocks == 0 or N == 0:
        # no launch, as in JAX (a zero-size grid is a launch error)
        return torch.zeros((m, N), dtype=dtype, device=b.device)
    out = torch.empty((m, N), dtype=dtype, device=b.device)
    args = (indptr.data_ptr(), indices.data_ptr(), blocks.data_ptr(),
            b.data_ptr(), out.data_ptr(), indptr.numel() - 1, R, C, m, K, N)
    if dtype == torch.float32:
        err = _build.launch(b.get_device(), "spmm_bsr_spmm", *args)
    else:
        err = _build.launch(b.get_device(), "spmm_bsr_spmm_wide", *args,
                            _WIDE[dtype])
    _build.check(err, "bsr_spmm")
    _build.LAUNCHES["bsr_spmm"] += 1
    return out


def spmm_bsr(a_bsr, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A a BSR and B a (K, N) tensor of A's dtype on A's
    device (the eager wrapper of the TPU kernel)."""
    return bsr_spmm(a_bsr.indptr, a_bsr.indices, a_bsr.data, b.contiguous(),
                    a_bsr.shape[0])
