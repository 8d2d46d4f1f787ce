"""Laws of the operands' matrices, one module each, found by the `law` a
matrix entry of a configuration names (`uniform` where it names none).
Each has `make(spec, seed, dtype, device) -> operands.Csr` and
`small(spec)`, the spec at which the CPU tests run it."""
