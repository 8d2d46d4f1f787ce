"""The port's experiment suites: the run-to-run determinism suite
(`deterministic`, with its generator `run_alg`) and the cross-check
against the native C++ replay (`cross_check`).  Each runs as a module,
`python3 -m spmm_tpu_torch.experiments.<name>`, on the card unless
`--device cpu` is given."""
