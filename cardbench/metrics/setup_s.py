"""setup_s: process start to the first timed call: imports, the kernels'
build or load, operands from the seed, plans, warm-up."""


def read(run):
    return run.setup_s
