"""PNGs of the speed drivers' JSON lines.

    python3 -m spmm_tpu_torch.benchmarks.make_figures RESULTS \\
        [--outdir build/figures] [--grid-json GRID]

Port of `benchmarks/make_figures.py`: from a file holding the drivers'
`--json` lines (other lines are skipped), `alg_comparison.png` (median ms
and ΔPeak MB per alg and cell, side by side) and `runtime_vs_density.png`
(dense and sparse ms per size against density: the break-even curve);
with `--grid-json`, `alg_comparison_grid.png` from an `alg_comparison
--save-grid` file (the port's ms beside torch's CSR @ CSR per alg and
cell).  It needs matplotlib, which the card's machine lacks: draw where
the JSON lines were copied to.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_lines(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def fig_alg_comparison(rows, out: str):
    """Median ms and ΔPeak MB per alg, grouped by (size, density)."""
    data = [r for r in rows if r.get("bench") == "alg_comparison"]
    if not data:
        return None
    plt = _pyplot()
    configs = sorted({(r["size"], r["density"]) for r in data})
    algs = sorted({r["alg"] for r in data})
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    width = 0.8 / len(algs)
    for ax, key, scale, label in (
            (axes[0], "median_ms", 1.0, "median ms per call"),
            (axes[1], "delta_hbm_bytes", 2.0**-20, "ΔPeak MB")):
        for ai, alg in enumerate(algs):
            xs, ys = [], []
            for ci, cfg in enumerate(configs):
                match = [r for r in data if (r["size"], r["density"]) == cfg
                         and r["alg"] == alg and r.get(key) is not None]
                if match:
                    xs.append(ci + ai * width)
                    ys.append(match[0][key] * scale)
            ax.bar(xs, ys, width=width, label=f"alg{alg}")
        ax.set_xticks(range(len(configs)),
                      [f"n={s}\nρ={d}" for s, d in configs])
        ax.set_ylabel(label)
        ax.set_yscale("log")
        ax.legend()
    axes[0].set_title("SpGEMM time per call")
    axes[1].set_title("SpGEMM ΔPeak device memory")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def fig_break_even(rows, out: str):
    """Dense and sparse ms against density, one pair of curves a size."""
    data = [r for r in rows if r.get("bench") == "dense_vs_sparse"]
    by_size = collections.defaultdict(list)
    for r in data:
        if r.get("dense_ms") and r.get("sparse_ms"):
            by_size[r["size"]].append((r["density"], r["dense_ms"],
                                       r["sparse_ms"]))
    if not by_size:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for size, pts in sorted(by_size.items()):
        pts.sort()
        ds = [p[0] for p in pts]
        ax.plot(ds, [p[1] for p in pts], "--", label=f"dense n={size}")
        ax.plot(ds, [p[2] for p in pts], "-o", label=f"sparse n={size}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("density")
    ax.set_ylabel("ms")
    ax.legend(fontsize=8)
    ax.set_title("Dense vs sparse GEMM break-even")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def alg_grid_figure(json_path: str, out: str):
    """One panel a (size, density) cell of a `--save-grid` file: the
    port's median ms per alg beside torch's CSR @ CSR."""
    with open(json_path) as f:
        cells = json.load(f)["cells"]
    panels = sorted({(c["size"], c["density"]) for c in cells})
    if not panels:
        return None
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(panels),
                             figsize=(3.1 * len(panels), 3.4), squeeze=False)
    for ax, (n, dens) in zip(axes[0], panels):
        rows = sorted((c for c in cells
                       if (c["size"], c["density"]) == (n, dens)),
                      key=lambda c: c["alg"])
        x = list(range(len(rows)))
        w = 0.38
        ax.bar([i - w / 2 for i in x], [c["median_ms"] for c in rows], w,
               label="spmm_tpu_torch")
        ax.bar([i + w / 2 for i in x],
               [c.get("cusparse_ms") or 0.0 for c in rows], w,
               label="torch CSR @ CSR")
        ax.set_xticks(x, [f"ALG{c['alg']}" for c in rows], fontsize=8)
        ax.set_title(f"n={n}  ρ={dens}", fontsize=9)
    axes[0][0].set_ylabel("ms per call", fontsize=8)
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=160)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("results", nargs="?",
                   help="a file with the drivers' JSON lines")
    p.add_argument("--outdir", default=os.path.join("build", "figures"),
                   help="where the PNGs go (default build/figures; the "
                        "repo's figures/ holds the JAX package's)")
    p.add_argument("--grid-json",
                   help="an alg_comparison --save-grid file")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    written = []
    if args.grid_json:
        written.append(alg_grid_figure(
            args.grid_json, os.path.join(args.outdir,
                                         "alg_comparison_grid.png")))
    if args.results:
        rows = load_lines(args.results)
        if not rows:
            print("no JSON rows found", file=sys.stderr)
        written.append(fig_alg_comparison(
            rows, os.path.join(args.outdir, "alg_comparison.png")))
        written.append(fig_break_even(
            rows, os.path.join(args.outdir, "runtime_vs_density.png")))
    return [w for w in written if w]


if __name__ == "__main__":
    main()
