"""The numbers that decide `correct`, and their verdict.

An answer is of one of two kinds, read from what the entry's `answer`
returns.  A CSR, a tuple (indptr, indices, data), against the plain
reference's:

* `structure_mismatch`: indptr entries that differ, plus indices that
  differ where the lengths agree, plus the difference of the lengths.
  Exact: the limit is 0.
* `value_err`: max |c - r| / max |r| over the entries, where the structures
  agree (None, and a failure, where they do not).

A dense answer, a tensor, against the reference's:

* `shape_mismatch`: the difference of the element counts, or 1 where the
  counts agree and the shapes do not.  Exact: the limit is 0.
* `value_err`: max |y - r| / max |r| in float64, where the shapes agree.

A number that reads NaN is no number (None), and fails its limit.
Besides: `failed`, the calls that raised (limit 0), and `uncompared`, the
sample times that got no answer of their own (at most all but one).
Every limit is an upper one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# the numbers of each kind of answer, as a cell's limits name them
KINDS = {"csr": ("structure_mismatch", "value_err"),
         "dense": ("shape_mismatch", "value_err")}


def numbers(got, ref) -> Dict[str, Optional[float]]:
    g_ip, g_ix, g_v = (x.to(torch.float64) if i == 2 else x.to(torch.int64)
                       for i, x in enumerate(got))
    r_ip, r_ix, r_v = ref[0].to(torch.int64), ref[1].to(torch.int64), ref[2]
    if g_ip.shape != r_ip.shape:
        mismatch = abs(g_ip.numel() - r_ip.numel()) + abs(
            g_ix.numel() - r_ix.numel())
    else:
        n = min(g_ix.numel(), r_ix.numel())
        mismatch = (int((g_ip != r_ip).sum()) + int((g_ix[:n] != r_ix[:n])
                    .sum()) + abs(g_ix.numel() - r_ix.numel()))
    if mismatch or g_v.numel() != r_v.numel():
        return {"structure_mismatch": float(mismatch), "value_err": None}
    scale = float(r_v.abs().max()) if r_v.numel() else 0.0
    err = float((g_v - r_v).abs().max()) if r_v.numel() else 0.0
    return {"structure_mismatch": 0.0,
            "value_err": err / scale if scale else err}


def dense(got: torch.Tensor, ref: torch.Tensor
          ) -> Dict[str, Optional[float]]:
    g, r = got.to(torch.float64), ref.to(torch.float64)
    if g.shape != r.shape:
        return {"shape_mismatch": float(abs(g.numel() - r.numel()) or 1),
                "value_err": None}
    scale = float(r.abs().max()) if r.numel() else 0.0
    err = float((g - r).abs().max()) if r.numel() else 0.0
    return {"shape_mismatch": 0.0,
            "value_err": err / scale if scale else err}


def host(answer):
    """An answer, or a reference's, on the host."""
    if isinstance(answer, torch.Tensor):
        return answer.cpu()
    return tuple(x.cpu() for x in answer)


def numbers_of(got, ref) -> Dict[str, Optional[float]]:
    """The numbers of an answer of either kind; NaN reads None."""
    found = (dense if isinstance(got, torch.Tensor) else numbers)(got, ref)
    return {name: None if value is not None and math.isnan(value) else value
            for name, value in found.items()}


def over(c: dict) -> bool:
    """A check, {"value", "limit"}, that fails: no number, or over."""
    return c["value"] is None or c["value"] > c["limit"]


def numbers_over(checks: dict) -> list:
    """The names of a result's numbers of the answers (not `failed`, not
    `uncompared`) that fail their limits."""
    return [name for name, c in checks.items()
            if name not in ("failed", "uncompared") and over(c)]


def judge(seen: dict, limits: dict, failed: int, samples: int
          ) -> Tuple[bool, list, dict]:
    """(correct, lines for standard error, the result's `checks`)."""
    checks = {"failed": {"value": failed, "limit": 0},
              "uncompared": {"value": samples - seen["compared"],
                             "limit": samples - 1}}
    for name, limit in limits.items():
        checks[name] = {"value": seen["numbers"].get(name), "limit": limit}
    ok = True
    lines = []
    for name, c in checks.items():
        good = not over(c)
        ok &= good
        lines.append(f"check {name} {c['value']} limit {c['limit']} "
                     f"{'ok' if good else 'FAILED'}")
    return ok, lines, checks
