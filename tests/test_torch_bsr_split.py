"""The arithmetic of the card's `bsr_spmm` (3xTF32 on the tensor cores),
emulated in float32 with torch, held to the gate its results are held to on
the card: within 1e-6 * (|A| @ |X|)_ij of the float64 product, per entry.

The emulation follows `csrc/bsr_spmm.cu` step by step: each operand split
into hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away from
zero, to 10 mantissa bits: `cvt.rna.tf32.f32`); per step of 8 along K, the
three products X_lo A_hi, X_hi A_lo, X_hi A_hi into a fresh accumulator,
each `mma` the exact sum of its 8 products and its addend rounded to
float32, once to nearest and once toward zero (the tensor core's accumulate
truncates: the pessimistic model); then the running sum takes each step's
partial with one float32 add, blocks in stored order, K in order.

Margin (worst |emulation - float64| / (1e-6 |A||X|), measured on the CPU):
0.53 at the 128x128 blocks of U[0,1) values times U[0,1) X (toward zero;
0.52 to nearest), 0.10 with N(0,1) values, 0.29 over a 10^4 spread of
magnitudes, 0.19 at the (8, 128) tiling: at most about half the 1.0
allowed.  One tf32 pass alone misses the gate by far (ratios of 118 to
445), so the split is what holds it; one truncating accumulator a block
misses it too (1.42 at the U[0,1) blocks), so the kernel restarts it every
8 along K.  The card's own results are held to the same gate by
tests/test_torch_cuda.py and chip_smoke.py phase 12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu_torch as pt  # noqa: E402

GATE = 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (ties away from zero), as float32:
    the magnitude's bits rounded at bit 13 (the sign bit is apart)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(c: torch.Tensor, terms: torch.Tensor, rounding: str) -> torch.Tensor:
    """c + terms (float64, exact here: tf32 products are 22-bit) rounded to
    float32, to nearest or toward zero."""
    s = c.double() + terms
    f = s.float()
    if rounding == "zero":
        over = f.double().abs() > s.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def emulate(indptr, indices, blocks, x, m, rounding="zero", passes=3,
            group=1):
    """(m, N) = A_bsr @ x as the card's kernel computes it: a fresh mma
    accumulator every `group` steps of 8 along a block's K (the kernel's 1;
    16 at C = 128 is one accumulator a block); passes=1: one tf32 product,
    no split."""
    nb, R, C = blocks.shape
    K, N = x.shape
    mb = indptr.numel() - 1
    Cp = -(-C // 8) * 8
    xb = torch.nn.functional.pad(x, (0, 0, 0, (-K) % C)).view(-1, C, N)
    slabs = torch.nn.functional.pad(xb[indices.long()], (0, 0, 0, Cp - C))
    a = torch.nn.functional.pad(blocks, (0, Cp - C))
    (ah, al), (xh, xl) = split(a), split(slabs)
    partials = []
    for i, s in enumerate(range(0, Cp, 8)):
        ks = slice(s, s + 8)

        def prod(u, v):
            return torch.bmm(u[:, :, ks].double(), v[:, ks, :].double())

        if i % group == 0:
            d = torch.zeros((nb, R, N), dtype=torch.float32)
        if passes == 1:
            d = mma(d, prod(ah, xh), rounding)
        else:
            d = mma(d, prod(ah, xl), rounding)
            d = mma(d, prod(al, xh), rounding)
            d = mma(d, prod(ah, xh), rounding)
        if i % group == group - 1 or s + 8 == Cp:
            partials.append(d)
    d = torch.stack(partials, 1)  # (nb, partials a block, R, N)
    counts = (indptr[1:] - indptr[:-1]).long()
    acc = torch.zeros((mb, R, N), dtype=torch.float32)
    for j in range(int(counts.max()) if mb else 0):
        rows = torch.nonzero(counts > j).view(-1)
        p = indptr[:-1].long()[rows] + j
        for s in range(d.shape[1]):
            acc[rows] = acc[rows] + d[p, s]
    return acc.view(mb * R, N)[:m]


def worst_ratio(got, a64: np.ndarray, x64: np.ndarray) -> float:
    exact = a64 @ x64
    scale = np.abs(a64) @ np.abs(x64)
    err = np.abs(got.double().numpy() - exact)
    assert np.all(err[scale == 0] == 0)
    return float(np.max(err[scale > 0] / (GATE * scale[scale > 0]),
                        initial=0.0))


def _values(rng, shape, kind):
    if kind == "uniform":
        return rng.random(shape, dtype=np.float32)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    # magnitudes spread over 10^4, random signs
    mag = 10.0 ** rng.uniform(-2.0, 2.0, shape)
    return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def _block_case(kind):
    """Four block rows of 128x128 blocks (5, 0, 3 and 1 of them),
    X of 64 columns, both from one value distribution."""
    rng = np.random.default_rng({"uniform": 1, "normal": 2, "spread": 3}[kind])
    R = C = 128
    nbc = 6
    counts = [5, 0, 3, 1]
    indices = np.concatenate([np.sort(rng.choice(nbc, c, replace=False))
                              for c in counts]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    blocks = _values(rng, (len(indices), R, C), kind)
    x = _values(rng, (nbc * C, 64), kind)
    a64 = np.zeros((len(counts) * R, nbc * C))
    for r in range(len(counts)):
        for p in range(indptr[r], indptr[r + 1]):
            c = indices[p]
            a64[r * R:(r + 1) * R, c * C:(c + 1) * C] = blocks[p]
    args = tuple(torch.from_numpy(v) for v in (indptr, indices, blocks, x))
    return args + (len(counts) * R,), a64, x.astype(np.float64)


def _tiled_case():
    """A random CSR (U[0,1) values) re-tiled at (8, 128) by the port's
    tobsr(), as spmm(via="bsr_pallas") tiles one, with ragged K."""
    a = pt.random(300, 3000, 0.02, format="csr", seed=8, device="cpu")
    ab = a.tobsr((8, 128))
    x = np.random.default_rng(9).standard_normal((3000, 48)).astype(
        np.float32)
    args = (ab.indptr, ab.indices, ab.data, torch.from_numpy(x), 300)
    return args, a.toarray().double().numpy(), x.astype(np.float64)


CASES = {"blocks128 uniform": lambda: _block_case("uniform"),
         "blocks128 normal": lambda: _block_case("normal"),
         "blocks128 spread 1e4": lambda: _block_case("spread"),
         "csr tiled (8, 128)": _tiled_case}


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      -(one + ulp / 2), one + 1.5 * ulp, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 0.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))


def test_split_keeps_22_bits():
    x = torch.from_numpy(_values(np.random.default_rng(0), 4096, "spread"))
    hi, lo = split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert not bool(((hi.view(torch.int32) | lo.view(torch.int32))
                     & 0x1FFF).any())


@pytest.mark.parametrize("rounding", ["nearest", "zero"])
@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_emulation_within_gate(case, rounding):
    args, a64, x64 = CASES[case]()
    assert worst_ratio(emulate(*args, rounding=rounding), a64, x64) <= 1.0


def test_one_tf32_pass_misses_the_gate():
    args, a64, x64 = CASES["blocks128 normal"]()
    assert worst_ratio(emulate(*args, passes=1), a64, x64) > 10.0


def test_one_truncating_accumulator_a_block_misses_the_gate():
    """Why the kernel restarts its mma accumulator every 8 along K: 48
    truncating accumulates into one register over a 128-wide block bias
    the sum of positive terms past the gate."""
    args, a64, x64 = CASES["blocks128 uniform"]()
    assert worst_ratio(emulate(*args, group=16), a64, x64) > 1.0
    assert worst_ratio(emulate(*args, group=16, rounding="nearest"), a64,
                       x64) <= 1.0
