"""The port's speed drivers, each a module run as
`python3 -m spmm_tpu_torch.benchmarks.<name>`, on the card unless
`--device cpu` is given:

  * `alg_comparison`: SpGEMM ALG1/2/3 time, device busy and ΔPeak per
    size x density, beside torch's CSR @ CSR (cuSPARSE);
  * `dense_vs_sparse`: dense GEMM against sparse SpGEMM (or SpMM) over
    size x density, and the break-even density per size;
  * `spgemm_vs_spmv`: SpGEMM over the 9 format pairs and SpMV per format,
    scipy on the host against the card end to end;
  * `component_profile`: each stage of alg1, ESC, SpMV and SpMM timed on
    its own;
  * `make_figures`: PNGs of their JSON lines (needs matplotlib; never runs
    on the card).

`python3 -m spmm_tpu_torch.benchmarks --out FILE` runs the first three at
the sweep's defaults under `--json` and writes what they print to FILE.
The numerical-error study is `spmm_tpu_torch.experiments.numerical_error`.
"""
