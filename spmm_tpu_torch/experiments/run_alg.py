"""Generate seeded matrices, multiply them with one SpGEMM algorithm, and
dump each product as text.

    python3 -m spmm_tpu_torch.experiments.run_alg --alg 2 --out F \
        [--seed 2008] [--sizes ...] [--densities ...] [--chunk-fraction 0.2]
        [--device cuda]

Port of `experiments/deterministic/run_alg.py` (the reference's
deterministic/cupy_alg{1,2,3}.py): for each size and density, A and B come
from the port's generator with seeds `seed` and `seed + 1`,
C = spgemm(A, B, alg) is computed and its nnz, indptr, indices and the
bits of its data (`%u`) are appended to the output file.  Two processes
running it must write byte-identical files (`deterministic` diffs them).
"""

from __future__ import annotations

import argparse

import numpy as np

SIZES = [32, 64, 128, 256, 512, 1024]
DENSITIES = [0.01, 0.1, 0.3, 0.5]


def dump(f, alg: int, seed: int, sizes, densities, chunk_fraction: float,
         device) -> None:
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.sparse.base import host

    for size in sizes:
        for density in densities:
            a = pt.random(size, size, density, format="csr", seed=seed,
                          device=device)
            b = pt.random(size, size, density, format="csr", seed=seed + 1,
                          device=device)
            c = pt.spgemm(a, b, alg=alg, chunk_fraction=chunk_fraction)
            f.write(f"# size={size} density={density} alg={alg}\n")
            f.write(f"nnz {c.nnz}\n")
            np.savetxt(f, host(c.indptr), fmt="%d")
            np.savetxt(f, host(c.indices), fmt="%d")
            # bitwise-comparable float encoding: the raw bit pattern
            np.savetxt(f, host(c.data).view(np.uint32), fmt="%u")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--alg", type=int, required=True, choices=[1, 2, 3])
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=2008)
    p.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    p.add_argument("--densities", type=float, nargs="+", default=DENSITIES)
    p.add_argument("--chunk-fraction", type=float, default=0.2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(args.out, "w") as f:
        dump(f, args.alg, args.seed, args.sizes, args.densities,
             args.chunk_fraction, args.device)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
