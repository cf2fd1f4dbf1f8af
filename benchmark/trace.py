"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: the device's operations (kernels, copies, sets)
with their names and times, the share of the window in which one ran, the
benchmark's own spans (``bench.*`` annotations), and the breakdown printed
with a traced run.

The window is taken on the trace's own clock, between the marker kernels
the harness launches at its ends; the benchmark's spans, taken on the
host's clock, are moved onto it by the first marker's offset.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    ops: list                     # (name, start_ns, end_ns) of device operations in the window
    spans: list                   # (name, start_ns, end_ns) of bench.* annotations
    gaps: list = field(default_factory=list)   # (start_ns, end_ns) of idle stretches

    def kernel_seconds(self, names: tuple[str, ...]) -> tuple[float, int]:
        """Summed seconds and count of the kernels whose function name (the
        identifier before any template or argument list) is in ``names``."""
        pat = re.compile(r"(?:^|[\s:])(" + "|".join(map(re.escape, names)) + r")(?:<|\(|$)")
        sel = [(s, e) for n, s, e in self.ops if pat.search(n)]
        return sum(e - s for s, e in sel) / 1e9, len(sel)

    def kernel_count(self) -> int:
        return sum(1 for n, _, _ in self.ops if not n.startswith(("Memcpy", "Memset")))

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle gaps, each named by the benchmark span open at its start."""
        per = defaultdict(float)
        for n, s, e in self.ops:
            per[n] += (e - s) / 1e9
        top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
        named = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]:
            inner = [sp for sp in self.spans if sp[1] <= s < sp[2] and sp[0] != "bench.item"]
            where = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "between items"
            named.append([f"idle in {where}", (e - s) / 1e9])
        return {"device_ops": [[n[:200], v] for n, v in top], "idle_gaps": named}


MARKER = "spin_kernel"


def reduce(prof, marks: list[int], intervals: list[tuple[str, int, int]]) -> TraceData:
    """``prof``: a profiler of device activity over the window, with a
    marker kernel at each end launched at the host times ``marks`` (ns)
    and one more ahead of them and after them;
    ``intervals``: the benchmark's spans on the host clock."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
    found = sorted((s, e) for n, s, e in ops if re.search(r"\b" + MARKER + r"\b", n))
    # the window's two markers: the pair whose distance on the trace's clock
    # is the host's (a lost marker ahead or after leaves the pair whole)
    host = marks[1] - marks[0]
    pairs = [(abs((b[0] - a[0]) - host), a, b) for i, a in enumerate(found) for b in found[i + 1:]]
    if not pairs or min(pairs)[0] > 0.01 * host + 1e7:
        raise RuntimeError(f"no two of the trace's {len(found)} marker kernels lie the "
                           f"window's {host / 1e9} s apart")
    _, (s0, w0), (w1, _) = min(pairs)
    # the launch latency is in the offset: host spans land a few us late
    offset = s0 - marks[0]
    spans = [(f"bench.{n}", a + offset, b + offset) for n, a, b in intervals]
    ops = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in ops if e > w0 and s < w1),
                 key=lambda o: o[1])
    busy, gaps, cur_s, cur_e = 0, [], None, None
    last = w0
    for _, s, e in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = max(last, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last:
        gaps.append((last, w1))
    return TraceData(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops, spans=spans,
                     gaps=gaps)
