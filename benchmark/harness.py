"""The benchmark's run: one cell of ``BENCHMARK.json``, one seed, one
window.

A run builds the cell's system (``systems/<system>.py``, named by the
configuration's file) in set-up, serves its traffic back to back for at
least ``--seconds`` on the host's clock, closes the window at the end of the
item in flight, reads its metrics (``metrics/<name>.py``, one reader each),
frees the program's state, runs the plain reference on a sample of what the
window produced, and prints one JSON line.  With ``--trace 1`` the window
runs under ``torch.profiler`` and the per-layer metrics are read; with
``--trace 0`` the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # the benchmark's folder
CHECKOUT = ROOT.parent                          # the checkout it runs from
FORBIDDEN = ("jax", "jaxlib", "flax", "audiolab_tpu")


def cache_env() -> dict[str, str]:
    """Every build and kernel cache the program or its libraries may write,
    at fixed paths inside the checkout (``build/`` is git-ignored)."""
    b = CHECKOUT / "build"
    return {"TORCH_EXTENSIONS_DIR": str(b / "torch_extensions"),
            "TRITON_CACHE_DIR": str(b / "triton"),
            "CUDA_CACHE_PATH": str(b / "nv_compute_cache"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``audiolab_tpu_torch`` is not
    ``audiolab_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path (names may hold '-'
    and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plugin(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark's folder."""
    return load_module(ROOT / kind / f"{name}.py",
                       f"benchmark_{kind}_" + name.replace("-", "_").replace(".", "_"))


def benchmark_spec() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> tuple[dict, dict]:
    """The workload's entry and its configuration's entry."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    return w, c


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


# ---------------------------------------------------------------- records

@dataclass
class Record:
    """One item the window served: host clock bounds, the work it carried
    (``units``), its spans' seconds and its counters' deltas."""

    t0: float
    t1: float = 0.0
    units: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    ok: bool = True


class Spans:
    """The benchmark's own spans around calls into the program's layers.
    Off (``trace`` False) a span costs nothing and records nothing; on, it
    is closed by ``synchronize``, its seconds go to the current record and
    its host-clock bounds to ``intervals`` (the trace names idle gaps by
    them)."""

    def __init__(self, trace: bool, sync):
        self.trace, self.sync, self.record = trace, sync, None
        self.intervals: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.trace:
            yield
            return
        t0 = time.perf_counter_ns()
        yield
        self.sync()
        t1 = time.perf_counter_ns()
        self.intervals.append((name, t0, t1))
        if self.record is not None:
            self.record.spans[name] = self.record.spans.get(name, 0.0) + (t1 - t0) / 1e9


@dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    records: list
    window_s: float
    window_peak_bytes: int
    device: dict
    system: object
    peaks: dict
    trace_data: object = None

    def units(self, key: str) -> float:
        return sum(r.units.get(key, 0.0) for r in self.records)

    def span_s(self, name: str) -> float:
        return sum(r.spans.get(name, 0.0) for r in self.records)


def peaks_for(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    an empty dict for a card the table does not hold."""
    table = json.loads((ROOT / "peaks.json").read_text())
    for key, val in table.items():
        if not key.startswith("_") and key in kind:
            return val
    return {}


def tr_mark(torch) -> int:
    """A marker kernel (``spin_kernel``) on an idle device; returns the
    host clock (ns) just before its launch."""
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


# ---------------------------------------------------------------- the run

def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell and print one JSON line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--patch", default=None,
                   help="a control or a planted fault of the cell's system (its PATCHES): "
                        "the run then has to come out not correct")
    return p.parse_args(argv)


def fail(msg: str, code: int = 3) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, t_start: float | None = None, require_card: bool = True,
         device: str = "cuda") -> int:
    """One run; returns the exit code.  ``require_card=False`` and
    ``device`` let the tests drive a run on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = benchmark_spec()
    try:
        work, conf = cell(spec, args.workload)
    except KeyError as e:
        return fail(str(e), 2)

    import torch

    if require_card:
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark measures the card and has no CPU mode")
        if torch.cuda.device_count() < work["chips"]:
            return fail(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                        f"{work['chips']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = json.loads((CHECKOUT / conf["file"]).read_text())
    mix = json.loads((ROOT / "traffic" / f"{work['traffic']}.json").read_text())
    spans = Spans(bool(args.trace), sync)
    sysmod = plugin("systems", cfg["system"])
    system = sysmod.System(cfg, mix, args.seed, dev, spans)
    if args.patch is not None:
        sysmod.PATCHES[args.patch](system)
    system.setup()
    sync()
    # the seconds the reference spent making the cell's inputs are not the
    # program's set-up
    setup_s = time.perf_counter() - t_start - getattr(system, "reference_s", 0.0)
    print(f"benchmark: set-up {setup_s!r} s, and {getattr(system, 'reference_s', 0.0)!r} s "
          "of the reference's inputs left out", file=sys.stderr, flush=True)

    records = []
    profiler = None
    marks: list[int] = []
    if args.trace and cuda:
        # device activity only (CUPTI): recording every host op would slow a
        # step of many small ops by half.  A marker kernel at each end of
        # the window ties the host's clock to the trace's.  A trace can
        # lose a kernel at either end of the tracing, so one more marker goes
        # ahead of the window's and one after it.
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CUDA])
        profiler.__enter__()
        tr_mark(torch)
        time.sleep(0.5)
        marks.append(tr_mark(torch))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    try:
        while True:
            rec = Record(t0=time.perf_counter())
            spans.record = rec
            with spans("item"):
                system.serve(rec)
            sync()
            rec.t1 = time.perf_counter()
            records.append(rec)
            if rec.t1 - w0 >= args.seconds:
                break
    finally:
        spans.record = None
        if profiler is not None:
            marks.append(tr_mark(torch))
            time.sleep(0.5)
            tr_mark(torch)
            profiler.__exit__(None, None, None)
    window_s = records[-1].t1 - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": work["chips"] if cuda else 1,
                   "memory_peak_bytes": int(peak)}
    run = Run(setup_s, records, window_s, peak, device_info, system,
              peaks_for(device_info["kind"]))
    breakdown = None
    if args.trace:
        from benchmark import trace as tr

        t_red = time.perf_counter()
        run.trace_data = (tr.reduce(profiler, marks, spans.intervals) if profiler is not None
                          else tr.TraceData(window_s, 0.0, [], []))
        print(f"benchmark: trace of {len(run.trace_data.ops)} device operations read in "
              f"{time.perf_counter() - t_red:.1f} s", file=sys.stderr, flush=True)
        device_info["busy_s"] = run.trace_data.busy_s
        device_info["window_s"] = run.trace_data.window_s
        breakdown = run.trace_data.breakdown()
        del profiler

    metrics = {}
    for m in metrics_for(spec, args.workload, bool(args.trace)):
        value = plugin("metrics", m["name"]).read(run)
        if value is None:
            print(f"benchmark: metric {m['name']} found nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    system.release()
    checks = system.check(records)
    failed = sum(not r.ok for r in records)
    correct = bool(checks) and failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    found = forbidden_modules()
    if found:
        return fail(f"forbidden modules loaded: {', '.join(found)}", 4)
    if cuda:
        try:
            limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                    "--format=csv,noheader"], capture_output=True, text=True,
                                   timeout=20).stdout.strip().splitlines()
            device_info["power_limit"] = limit[0] if limit else "unknown"
        except (OSError, subprocess.SubprocessError):
            device_info["power_limit"] = "unknown"
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
