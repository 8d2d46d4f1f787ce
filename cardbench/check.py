"""The numbers that decide `correct`, and their verdict.

For each compared answer, a CSR (indptr, indices, data) against the plain
reference's:

* `structure_mismatch`: indptr entries that differ, plus indices that
  differ where the lengths agree, plus the difference of the lengths.
  Exact: the limit is 0.
* `value_err`: max |c - r| / max |r| over the entries, where the structures
  agree (None, and a failure, where they do not).

Besides: `failed`, the calls that raised (limit 0), and `uncompared`, the
sample times that got no answer of their own (at most all but one).
Every limit is an upper one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
        good = c["value"] is not None and c["value"] <= c["limit"]
        ok &= good
        lines.append(f"check {name} {c['value']} limit {c['limit']} "
                     f"{'ok' if good else 'FAILED'}")
    return ok, lines, checks
