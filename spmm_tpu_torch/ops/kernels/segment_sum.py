"""In-order segment sums, in O(entries): JAX's bits without atomics.

The JAX package adds duplicate runs, axis sums, `diagonal` and the BSR
block-row sum with `jax.ops.segment_sum` / `.at[].add`, which on the CPU add
each segment in stored order from +0.0.  `segment_sum_inorder` gives the
same bits.  On a CPU tensor it runs `segment_sum_inorder_plain`, an
`index_add_` over the entries' segment ids (the CPU `index_add_` adds in
index order); on a CUDA tensor it launches `csrc/segment_sum.cu`, one thread
per (segment, column) adding its rows in order.  This is the port's own
kernel, not a TPU kernel: `index_add_` on the card adds with atomics.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops.kernels import _build

# the kernel's type codes; bool and narrow integers are summed as int32
# (exact, and wrapping as the narrow type would) and cast back
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
           torch.int64: 3, torch.float16: 4, torch.bfloat16: 5}
_VIA_INT32 = (torch.bool, torch.int8, torch.int16, torch.uint8)


def segment_sum_inorder_plain(values: torch.Tensor, starts: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each entry's segment id, then `index_add_`
    into zeros (in index order on the CPU; with atomics on a card)."""
    nseg = starts.numel()
    out = torch.zeros((nseg, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if values.shape[0] == 0 or nseg == 0:
        return out
    lengths = lengths.long()
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=values.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths  # each segment's first entry
    pos = starts.long()[seg] + torch.arange(seg.numel(),
                                            device=values.device) - first[seg]
    width = out[0].numel()
    keys = (seg[:, None] * width + torch.arange(width, device=seg.device))
    src = values.reshape(values.shape[0], width)[pos]
    return out.view(-1).index_add_(0, keys.view(-1), src.view(-1)).view(
        out.shape)


def segment_sum_inorder(values: torch.Tensor, starts: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Sum of the rows values[starts[s]:starts[s] + lengths[s]] of each
    segment s, for values (L,) or (L, ...); an empty segment is 0.  Each
    segment is summed in order from +0.0, ((0 + v0) + v1) + v2 ..., as
    JAX's `segment_sum` adds on the CPU.  No host sync, no atomics."""
    if values.device.type == "cpu":
        return segment_sum_inorder_plain(values, starts, lengths)
    if values.dtype in _VIA_INT32:
        out = segment_sum_inorder(values.to(torch.int32), starts, lengths)
        return out != 0 if values.dtype == torch.bool else out.to(
            values.dtype)
    if values.is_complex():
        return torch.view_as_complex(segment_sum_inorder(
            torch.view_as_real(values.contiguous()), starts, lengths))
    code = _DTYPES.get(values.dtype)
    if code is None:
        raise NotImplementedError(f"segment_sum_inorder of {values.dtype} "
                                  "on a CUDA device")
    nseg = starts.numel()
    out = torch.empty((nseg, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    width = out[0].numel() if nseg else 0
    if nseg == 0 or width == 0:
        return out
    if values.shape[0] == 0:
        return out.zero_()
    values = values.contiguous()
    starts = starts.to(torch.int64).contiguous()
    lengths = lengths.to(torch.int64).contiguous()
    err = _build.launch(values.get_device(), "spmm_segment_sum",
                        values.data_ptr(), starts.data_ptr(),
                        lengths.data_ptr(), nseg, width, code, out.data_ptr())
    _build.check(err, "segment_sum")
    _build.LAUNCHES["segment_sum"] += 1
    return out
