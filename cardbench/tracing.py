"""What a `torch.profiler` trace of the measured window says.

The harness marks the window with a `cardbench.window` span and each copy
of a sampled answer to the host with a `cardbench.keep` span.  From the
trace's raw events this module takes:

* the device's busy time: the union of the device events' intervals inside
  the window, less the events that start inside a `cardbench.keep` span
  (the harness's own copies);
* the device time by operation name;
* the idle gaps between busy intervals, each named by what the host was
  doing at its middle: the innermost host event open there.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "cardbench.window"
KEEP = "cardbench.keep"


@dataclass
class Trace:
    """A traced window: busy and window length in seconds, device time by
    operation and idle time by host activity in seconds."""
    busy_s: float
    window_s: float
    device_ops: Dict[str, float] = field(default_factory=dict)
    idle_gaps: Dict[str, float] = field(default_factory=dict)

    def top(self, which: str, count: int = 10) -> List[list]:
        items = sorted(getattr(self, which).items(), key=lambda kv: -kv[1])
        return [[name, s] for name, s in items[:count]]


def raw_events(prof) -> Tuple[list, list]:
    """(host, device) events of a finished profile, each (start_ns, end_ns,
    name), read from the profiler's raw results.  A span's copy on the
    device's timeline (a GPU user annotation, named as the span) is no
    device operation and is left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, device, spans = [], [], set()
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (s, s + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(item)
            if e.is_user_annotation():
                spans.add(item[2])
        elif not e.is_user_annotation():
            device.append(item)
    return host, [d for d in device if d[2] not in spans]


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def innermost(host: list, points: List[int]) -> List[str]:
    """For each point (ascending), the name of the host event open there
    that started last; "" where none is."""
    host = sorted(host)
    heap: list = []  # (-start, end, name) of the events begun so far
    j, names = 0, []
    for p in points:
        while j < len(host) and host[j][0] <= p:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        # an event over before p is over for every later point, and one
        # under it on the heap cannot be the answer while it is there
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "")
    return names


def summarize(host: list, device: list) -> Trace:
    windows = [(s, t) for s, t, n in host if n == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = windows[0]
    keeps = merged([(s, t) for s, t, n in host if n == KEEP])
    inner = [(s, t, n) for s, t, n in host if n not in (WINDOW, KEEP)]

    def in_keep(s):
        return any(k0 <= s <= k1 for k0, k1 in keeps)

    ops: Dict[str, float] = {}
    spans = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s or in_keep(s):
            continue
        ops[name] = ops.get(name, 0.0) + (t - s) / 1e9
        spans.append((s, t))
    busy = merged(spans)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: Dict[str, float] = {}
    names = innermost(inner, [(s + t) // 2 for s, t in gaps])
    for (s, t), name in zip(gaps, names):
        name = name or "harness loop"
        idle[name] = idle.get(name, 0.0) + (t - s) / 1e9
    return Trace(busy_s=sum(t - s for s, t in busy) / 1e9,
                 window_s=(w1 - w0) / 1e9, device_ops=ops, idle_gaps=idle)
