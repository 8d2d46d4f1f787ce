"""Law `stencil27`: HPCG's matrix, the 27-point stencil of a 3-D grid, as
`GenerateProblem_ref` (hpcg-benchmark/hpcg, `src/GenerateProblem_ref.cpp`)
builds it on one process.  A spec reads

    {"law": "stencil27", "grid": [nx, ny, nz]}

Row `iz*nx*ny + iy*nx + ix` holds one entry for each of the 27 offsets
(sz, sy, sx) in {-1, 0, 1}^3 whose neighbour lies inside the grid, at
column row + sz*nx*ny + sy*nx + sx: 26 on the diagonal, -1 off it.  The
loops run over sz, then sy, then sx, so the columns of a row ascend and
the CSR is canonical, with int32 indices.  The matrix draws nothing from
the seed; it is made on the device by a few vectorised torch calls.
"""

from __future__ import annotations

import torch

from cardbench.operands import Csr


def make(spec: dict, seed: int, dtype, device) -> Csr:
    nx, ny, nz = (int(g) for g in spec["grid"])
    n = nx * ny * nz
    row = torch.arange(n, dtype=torch.int32, device=device)
    at = (row % nx, row // nx % ny, row // (nx * ny))
    d = torch.arange(-1, 2, dtype=torch.int32, device=device)
    sz, sy, sx = (s.reshape(27) for s in
                  torch.meshgrid(d, d, d, indexing="ij"))
    valid = torch.ones((n, 27), dtype=torch.bool, device=device)
    for i, s, size in zip(at, (sx, sy, sz), (nx, ny, nz)):
        j = i[:, None] + s
        valid &= (j >= 0) & (j < size)
    cols = row[:, None] + (sz * (nx * ny) + sy * nx + sx)
    indices = cols[valid]
    data = torch.full((n, 27), -1.0, dtype=dtype, device=device)
    data[:, 13] = 26.0  # offset (0, 0, 0): the diagonal
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(valid.sum(1), 0)
    return Csr(indptr, indices, data[valid], (n, n))


def small(spec: dict) -> dict:
    """A grid of at most 6 x 5 x 4: every row length, and three different
    extents, so that a swapped axis shows."""
    return dict(spec, grid=[min(int(g), s)
                            for g, s in zip(spec["grid"], (6, 5, 4))])
