"""The alg1-against-alg3 numerical error study, in four subcommands.

    python3 -m spmm_tpu_torch.experiments.numerical_error distribution \\
        [--size 1024] [--density 0.1] [--chunk-fraction 0.3]
    python3 -m spmm_tpu_torch.experiments.numerical_error error \\
        [--sizes 256 512 1024] [--densities 0.01 0.1 0.5]
    python3 -m spmm_tpu_torch.experiments.numerical_error fraction \\
        [--size 1024] [--density 0.1] [--fractions ...] [--ref alg1|f64]
    python3 -m spmm_tpu_torch.experiments.numerical_error range \\
        [--size 512] [--density 0.1] [--highs 1 10 100 1000 10000]
        [--repeats 300]

each also taking [--seed 0] [--json] [--plot] [--out PNG] [--device cuda].

Port of `experiments/numerical_error/{distribution,error,fraction,range}.py`
(the reference's numerical_error/*.py).  A and B come from the port's
generator with seeds `seed` and `seed + 1`; C1 = spgemm(A, B, alg=1) and
C3 = spgemm(A, B, alg=3, chunk_fraction), and the error is max |C1 - C3|
over the dense difference, on the matrices' device:

  * `distribution`: max, mean and count of the nonzero |C1 - C3| at one
    cell (with `--plot`, a histogram of their log10);
  * `error`: max |C1 - C3| over sizes x densities (a heatmap);
  * `fraction`: the error of C3 against a reference for each
    chunk_fraction, the reference being C1 (`--ref alg1`) or scipy's
    float64 product of the same arrays (`--ref f64`), whose structure C3
    must match exactly;
  * `range`: the worst error over `repeats` pairs (seeds 2r and 2r + 1)
    with values U[0, high): the generator's U[0, 1) float32 values scaled
    as `jax.random.uniform(minval=0, maxval=high)` scales its own
    (`scale_uniform`).

Each row is printed as text and, with `--json`, as one JSON line holding
max|C| beside the error.  A figure is drawn only with `--plot`, which needs
matplotlib and raises ImportError without it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def operands(size: int, density: float, seed: int, device, high=None):
    """A and B (size^2, CSR, float32) with seeds `seed` and `seed + 1`;
    with `high`, their values scaled to U[0, high)."""
    import spmm_tpu_torch as pt

    out = []
    for s in (seed, seed + 1):
        a = pt.random(size, size, density, format="csr", seed=s,
                      device=device)
        if high is not None:
            a = pt.CSR.from_parts(a.indptr, a.indices,
                                  scale_uniform(a.data, high), a.shape,
                                  canonical=True)
        out.append(a)
    return tuple(out)


def scale_uniform(u: torch.Tensor, high: float) -> torch.Tensor:
    """U[0, 1) float32 values to U[0, high) as `jax.random.uniform` maps
    its own: max(0, u * (high - 0) + 0), every step in float32."""
    lo = torch.tensor(0.0, dtype=u.dtype, device=u.device)
    span = torch.tensor(high, dtype=u.dtype, device=u.device) - lo
    return torch.maximum(lo, u * span + lo)


def alg1_alg3(a, b, chunk_fraction: float):
    import spmm_tpu_torch as pt

    return (pt.spgemm(a, b, alg=1),
            pt.spgemm(a, b, alg=3, chunk_fraction=chunk_fraction))


def abs_diff(c1, c3) -> torch.Tensor:
    """|C1 - C3| as a dense matrix."""
    return (c1.toarray() - c3.toarray()).abs()


def max_abs(c) -> float:
    return float(c.data.abs().max()) if c.nnz else 0.0


def _plot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--plot draws with matplotlib, which is not "
                          "installed here; run without --plot, or draw "
                          "from the JSON lines where matplotlib is") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _emit(args, row: dict) -> dict:
    from spmm_tpu_torch.benchmarks.common import emit

    return emit({"experiment": "numerical_error", "cmd": args.cmd, **row},
                args.json)


def distribution(args, device) -> list:
    a, b = operands(args.size, args.density, args.seed, device)
    c1, c3 = alg1_alg3(a, b, args.chunk_fraction)
    diff = abs_diff(c1, c3)
    nz = diff[diff > 0]
    err, mean = float(diff.max()), float(diff.mean())
    print(f"n={args.size} density={args.density} "
          f"cf={args.chunk_fraction}")
    print(f"max |C1-C3| = {err:.3e}  mean = {mean:.3e}  "
          f"nonzero diffs = {nz.numel()}")
    row = _emit(args, {"size": args.size, "density": args.density,
                       "chunk_fraction": args.chunk_fraction, "max_err": err,
                       "mean_err": mean, "nonzero": nz.numel(),
                       "max_abs_c": max_abs(c1)})
    if args.plot:
        plt = _plot()
        plt.figure(figsize=(7, 4))
        if nz.numel():
            plt.hist(np.log10(nz.double().cpu().numpy()), bins=80)
        plt.xlabel("log10 |C_alg1 − C_alg3|")
        plt.ylabel("count")
        plt.title(f"SpGEMM alg1 vs alg3 error, n={args.size} "
                  f"ρ={args.density}")
        plt.tight_layout()
        plt.savefig(args.out or "error_distribution.png", dpi=120)
        print(f"wrote {args.out or 'error_distribution.png'}")
    return [row]


def error(args, device) -> list:
    rows = []
    errs = np.zeros((len(args.sizes), len(args.densities)))
    for i, size in enumerate(args.sizes):
        for j, density in enumerate(args.densities):
            a, b = operands(size, density, args.seed, device)
            c1, c3 = alg1_alg3(a, b, args.chunk_fraction)
            diff = abs_diff(c1, c3)
            errs[i, j] = float(diff.max()) if diff.numel() else 0.0
            print(f"n={size} d={density}: max err {errs[i, j]:.3e}")
            rows.append(_emit(args, {
                "size": size, "density": density,
                "chunk_fraction": args.chunk_fraction,
                "max_err": errs[i, j], "max_abs_c": max_abs(c1)}))
    if args.plot:
        plt = _plot()
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(np.log10(np.maximum(errs, 1e-300)), cmap="viridis")
        ax.set_xticks(range(len(args.densities)), args.densities)
        ax.set_yticks(range(len(args.sizes)), args.sizes)
        ax.set_xlabel("density")
        ax.set_ylabel("size")
        for i in range(errs.shape[0]):
            for j in range(errs.shape[1]):
                ax.text(j, i, f"{errs[i, j]:.1e}", ha="center",
                        va="center", color="w", fontsize=8)
        fig.colorbar(im, label="log10 max |C1 − C3|")
        plt.title("SpGEMM alg1 vs alg3 max-abs error")
        plt.tight_layout()
        plt.savefig(args.out or "error_heatmap.png", dpi=120)
        print(f"wrote {args.out or 'error_heatmap.png'}")
    return rows


def f64_reference(a, b):
    """scipy's float64 product of A's and B's arrays, canonical."""
    import scipy.sparse as sp

    from spmm_tpu_torch.sparse.base import host

    a64, b64 = (sp.csr_matrix((host(x.data).astype(np.float64),
                               host(x.indices), host(x.indptr)),
                              shape=x.shape) for x in (a, b))
    c = a64 @ b64
    c.sum_duplicates()
    c.sort_indices()
    return c


def fraction(args, device) -> list:
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.sparse.base import host

    a, b = operands(args.size, args.density, args.seed, device)
    if args.ref == "alg1":
        ref = pt.spgemm(a, b, alg=1)
    else:
        ref = f64_reference(a, b)
    rows = []
    errs = []
    for cf in args.fractions:
        c3 = pt.spgemm(a, b, alg=3, chunk_fraction=cf)
        if args.ref == "alg1":
            err = float(abs_diff(ref, c3).max())
            scale = max_abs(ref)
        else:
            # one structure (explicit accidental zeros kept by both)
            if not (np.array_equal(host(c3.indptr), ref.indptr)
                    and np.array_equal(host(c3.indices), ref.indices)):
                raise AssertionError(
                    f"fraction --ref f64: alg3 at chunk_fraction={cf} has "
                    "another structure than scipy's float64 product")
            err = (float(np.abs(host(c3.data).astype(np.float64)
                                - ref.data).max()) if ref.nnz else 0.0)
            scale = float(np.abs(ref.data).max()) if ref.nnz else 0.0
        errs.append(err)
        print(f"chunk_fraction={cf}: max err {err:.3e}", flush=True)
        rows.append(_emit(args, {
            "size": args.size, "density": args.density,
            "chunk_fraction": cf, "ref": args.ref, "max_err": err,
            "max_abs_c": scale}))
    if args.plot:
        plt = _plot()
        plt.figure(figsize=(6, 4))
        plt.plot(args.fractions, errs, "o-")
        plt.xlabel("chunk_fraction")
        plt.ylabel(f"max |C_{args.ref} − C_alg3|")
        plt.yscale("log")
        plt.title(f"n={args.size} ρ={args.density} (ref={args.ref})")
        plt.tight_layout()
        plt.savefig(args.out or "error_vs_fraction.png", dpi=120)
        print(f"wrote {args.out or 'error_vs_fraction.png'}")
    return rows


def value_range(args, device) -> list:
    rows = []
    worst = []
    for high in args.highs:
        w = 0.0
        scale = 0.0
        for rep in range(args.repeats):
            a, b = operands(args.size, args.density, rep * 2, device,
                            high=high)
            c1, c3 = alg1_alg3(a, b, args.chunk_fraction)
            w = max(w, float(abs_diff(c1, c3).max()))
            scale = max(scale, max_abs(c1))
        worst.append(w)
        print(f"high={high}: worst max err {w:.3e}", flush=True)
        rows.append(_emit(args, {
            "size": args.size, "density": args.density, "high": high,
            "repeats": args.repeats, "chunk_fraction": args.chunk_fraction,
            "max_err": w, "max_abs_c": scale}))
    if args.plot:
        plt = _plot()
        plt.figure(figsize=(6, 4))
        plt.plot(args.highs, worst, "o-")
        plt.xscale("log")
        plt.yscale("log")
        plt.xlabel("value range high")
        plt.ylabel("worst max |C_alg1 − C_alg3|")
        plt.title(f"n={args.size} ρ={args.density}, "
                  f"{args.repeats} repeats")
        plt.tight_layout()
        plt.savefig(args.out or "error_vs_range.png", dpi=120)
        print(f"wrote {args.out or 'error_vs_range.png'}")
    return rows


COMMANDS = {"distribution": distribution, "error": error,
            "fraction": fraction, "range": value_range}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--json", action="store_true")
    common.add_argument("--plot", action="store_true")
    common.add_argument("--out", default=None, help="the figure's path")
    common.add_argument("--device", default="cuda")
    for name, size, cf in (("distribution", 1024, 0.3),
                           ("fraction", 1024, None), ("range", 512, 0.3)):
        s = sub.add_parser(name, parents=[common])
        s.add_argument("--size", type=int, default=size)
        s.add_argument("--density", type=float, default=0.1)
        if cf is not None:
            s.add_argument("--chunk-fraction", type=float, default=cf)
    e = sub.add_parser("error", parents=[common])
    e.add_argument("--sizes", type=int, nargs="+", default=[256, 512, 1024])
    e.add_argument("--densities", type=float, nargs="+",
                   default=[0.01, 0.1, 0.5])
    e.add_argument("--chunk-fraction", type=float, default=0.3)
    f = sub.choices["fraction"]
    f.add_argument("--fractions", type=float, nargs="+",
                   default=[0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0])
    f.add_argument("--ref", choices=["alg1", "f64"], default="alg1")
    r = sub.choices["range"]
    r.add_argument("--highs", type=float, nargs="+",
                   default=[1, 10, 100, 1000, 10000])
    r.add_argument("--repeats", type=int, default=300)
    return p


def main(argv=None) -> list:
    from spmm_tpu_torch.benchmarks.common import driver_device

    args = parser().parse_args(argv)
    device = driver_device(f"numerical_error {args.cmd}", args.device)
    if args.plot:
        _plot()  # before any work: no matplotlib, no run
    return COMMANDS[args.cmd](args, device)


if __name__ == "__main__":
    main()
