"""Law `kronecker`: the Graph500 benchmark's graph (graph500.org, the
specification's section 3, "Graph Generation", and its reference
`kronecker_generator`), made undirected and row-normalised for a mean
aggregation.  A spec reads

    {"law": "kronecker", "scale": 22, "edgefactor": 16,
     "initiator": [0.57, 0.19, 0.19], "values": "mean", "seed_offset": 0}

and becomes an N x N canonical CSR, N = 2^scale, with int32 indices:

* M = edgefactor * N edges, each drawn a bit a level over `scale` levels:
  the row bit is 1 with probability 1 - (A + B), the column bit then 1
  with probability D / (C + D) where the row bit is 1, else B / (A + B)
  (A, B, C the initiator, D = 1 - A - B - C);
* the vertex labels permuted at random, as the reference generator does
  (the order of the edge list is left out: a CSR has none);
* undirected, as a GNN framework builds a graph from an edge list: each
  edge in both directions, self-loops dropped, duplicates merged;
* `values: "mean"`: every entry of row i holds 1 / deg(i), its row's
  length, so that A @ H is the mean over each vertex's neighbours
  (GraphSAGE's mean aggregation); an isolated vertex's row is empty.

Each matrix has its own `torch.Generator` on the device, seeded with the
run's seed plus its `seed_offset`: the same seed gives the same graph on
the same kind of device.  A few large torch calls make it on the device.
"""

from __future__ import annotations

import torch

from cardbench.operands import Csr, generator


def edges(scale: int, edgefactor: int, initiator, g: torch.Generator,
          device):
    """(src, dst) int64 of the M = edgefactor * 2^scale directed edges of
    the generator, vertex labels permuted."""
    a, b, c = (float(p) for p in initiator)
    n = 1 << scale
    m = edgefactor * n
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=g, device=device) > ab
        jj = torch.rand(m, generator=g, device=device) > torch.where(
            ii, c_norm, a_norm)
        src += ii.long() << level
        dst += jj.long() << level
    perm = torch.randperm(n, generator=g, device=device)
    return perm[src], perm[dst]


def mean_csr(src: torch.Tensor, dst: torch.Tensor, n: int, dtype) -> Csr:
    """The undirected graph of the edges (src, dst) on n vertices: both
    directions, no self-loops, duplicates merged, each entry 1 / deg(row)."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    rows, cols = key // n, key % n
    deg = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    indptr[1:] = torch.cumsum(deg, 0)
    data = (1.0 / deg[rows].to(torch.float64)).to(dtype)
    return Csr(indptr, cols.to(torch.int32), data, (n, n))


def make(spec: dict, seed: int, dtype, device) -> Csr:
    if spec.get("values", "mean") != "mean":
        raise ValueError(f"kronecker: unknown values {spec['values']!r}")
    g = generator(seed + int(spec.get("seed_offset", 0)), device)
    scale = int(spec["scale"])
    src, dst = edges(scale, int(spec["edgefactor"]), spec["initiator"], g,
                     device)
    return mean_csr(src, dst, 1 << scale, dtype)


def small(spec: dict) -> dict:
    """A scale of at most 8 (256 vertices, 4096 edges): hubs and isolated
    vertices both, as at full scale."""
    return dict(spec, scale=min(int(spec["scale"]), 8))
