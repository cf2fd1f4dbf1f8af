"""Shared arithmetic of the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations


def per_unit(total: float, units: float, scale: float = 1.0):
    return None if units <= 0 else scale * total / units


def roofline_share(run, kernel: str, names: tuple[str, ...], peak_key: str):
    """100 x the summed least time of the window's ``kernel`` calls (from
    their shapes, ``work/attention.py``) over the summed device time of the
    kernels of those ``names``.  Nothing when the
    window ran none of them, or when the program's launch counter disagrees
    with the calls counted from shapes (the work would then be counted for
    other calls than the ones timed)."""
    if run.trace_data is None or not run.peaks:
        return None
    calls = [c for c in run.system.work(run.records)["attention"] if c.kernel == kernel]
    launched = sum(r.counters.get(kernel, 0) for r in run.records)
    secs, n = run.trace_data.kernel_seconds(names)
    if not calls or n == 0 or launched != len(calls) or n != len(calls):
        return None
    least = sum(c.roofline_s(run.peaks[peak_key], run.peaks["hbm_bytes_per_s"]) for c in calls)
    return 100.0 * least / secs


def mfu(run, peak_key: str):
    """100 x the window's model FLOPs over its seconds over the peak."""
    if run.trace_data is None or not run.peaks:
        return None
    flops = run.system.work(run.records)["model_flops"]
    return 100.0 * flops / run.trace_data.window_s / run.peaks[peak_key]


def idle_share(run):
    if run.trace_data is None:
        return None
    t = run.trace_data
    return 100.0 * (1.0 - t.busy_s / t.window_s)
