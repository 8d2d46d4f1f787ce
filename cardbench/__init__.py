"""The benchmark of `spmm_tpu_torch` on one NVIDIA card.

One run measures one cell of `BENCHMARK.json` (a configuration under a
traffic mix) for a window of `--seconds` and prints one JSON line:

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json    dtype, precision, and each matrix by its law
    laws/<law>.py            `make` a matrix of a law; `small`, its CPU size
    traffic/<mix>.json       which entry is timed, its arguments, warm-up
    workloads/<cell>.json    the limits of the check and their readings
    entries/<entry>.py       set-up and the one timed call of an entry; its
                             faults and controls, for the tests
    metrics/<metric>.py      `read(run)`: one metric from a finished run
    reference/, work/        the plain reference and the work counts

An entry's answer is a CSR or a dense tensor, and `check.py` compares it
by the numbers of its kind.  So a cell of another entry or law comes as
new files and new `BENCHMARK.json` entries.

The harness imports nothing of the JAX package and none of the port's
speed studies, profiler helpers or test helpers.
"""
