"""Multi-process runs of the distribution layer: `launch` starts N ranks of
a module (each `python -m <module> ... --nprocs N --rank r --store PATH
--device D`, joined through a FileStore), `comm_runner` checks Aᵀ(A·1)
against scipy at any world size, and `footprint_curve` reads each rank's
peak memory of the replicated-x and the streamed-x SpMV.  `python3 -m
spmm_tpu_torch.experiments.distributed --nprocs N` runs comm_runner."""
