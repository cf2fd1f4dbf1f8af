"""The window and its rates, on a cell and a metric added by files alone:
a dummy system whose items take set times, one of them a stall inside the
window."""

import json
import subprocess
import sys
import textwrap

import pytest

import tiny

SYSTEM = '''
import time


class System:
    def __init__(self, cfg, mix, seed, dev, spans):
        self.times, self.i, self.span = mix["seconds"], 0, spans

    def setup(self):
        pass

    def serve(self, rec):
        with self.span("work"):
            time.sleep(self.times[self.i % len(self.times)])
        self.i += 1
        rec.units["audio_s"] = 1.0

    def work(self, records):
        return {"attention": [], "model_flops": 0.0}

    def release(self):
        pass

    def check(self, records):
        return [{"name": "items", "value": float(len(records) != 3), "limit": 0.5}]
'''

METRIC = '''"""Items a second by the window's records: a reader added by a file."""


def read(run):
    return len(run.records) / run.window_s
'''


@pytest.fixture(scope="module")
def dummy_tree(tree):
    b = tree / "benchmark"
    (b / "systems" / "dummy.py").write_text(SYSTEM)
    (b / "metrics" / "dummy_items_per_s.py").write_text(METRIC)
    (b / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "system": "dummy"}))
    # 0.05 s, 0.05 s, then a 0.4 s stall that crosses the 0.3 s mark
    (b / "traffic" / "dummy.json").write_text(json.dumps({"seconds": [0.05, 0.05, 0.4, 0.05]}))
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "test", "file": "benchmark/configs/dummy.json",
                            "reduced": []})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy",
                              "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "audio_s_per_s")["workloads"].append(
        "dummy.cell")
    spec["per_layer"].append({"name": "dummy_items_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "audio_s_per_s",
                              "workloads": ["dummy.cell"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))
    return tree


def test_rate_over_the_whole_window_with_a_stall(dummy_tree):
    out = tiny.result(tiny.run_cpu(dummy_tree, "dummy.cell", seconds=0.3))
    assert out["attempted"] == 3 and out["failed"] == 0 and out["correct"] is True
    rate = out["metrics"]["audio_s_per_s"]["value"]
    # three items over the window that the stall closes: 3 / ~0.5 s
    assert 3 / 0.56 < rate < 3 / 0.5
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_metric_added_by_a_file_is_read_in_the_traced_run(dummy_tree):
    out = tiny.result(tiny.run_cpu(dummy_tree, "dummy.cell", seconds=0.3, trace=1))
    assert set(out["metrics"]) == {"dummy_items_per_s"}
    assert 3 / 0.56 < out["metrics"]["dummy_items_per_s"]["value"] < 3 / 0.5
    assert out["device"]["window_s"] > 0.45


def test_no_card_no_result(tree):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(tree)!r}]
        from benchmark import harness
        sys.exit(harness.main(['--workload', 'tiny.chain', '--seed', '1', '--seconds', '1']))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_unknown_cell_fails(tree):
    proc = tiny.run_cpu(tree, "no.such.cell")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


class _Event:
    def __init__(self, name, start, dur):
        self._n, self._s, self._d = name, start, dur

    def device_type(self):
        return "DeviceType.CUDA"

    def is_user_annotation(self):
        return False

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _profile(events):
    from types import SimpleNamespace

    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("lost", [None, "ahead", "after"])
def test_trace_window_from_its_markers(lost):
    """The window lies between its two markers on the trace's clock even
    when the trace lost the marker ahead of them or after them; busy time
    and gaps are taken inside it."""
    from benchmark import trace

    off, ms = 7_000_000_000, 1_000_000       # trace clock = host clock + off
    marks = [100 * ms, 1100 * ms]            # host times of the window's markers
    spin = "spin_kernel(long)"
    events = [_Event(spin, marks[0] + off, ms), _Event(spin, marks[1] + off, ms),
              _Event("gemm", marks[0] + off + 10 * ms, 400 * ms),
              _Event("gemm", marks[0] + off + 600 * ms, 100 * ms)]
    if lost != "ahead":
        events.append(_Event(spin, marks[0] + off - 500 * ms, ms))
    if lost != "after":
        events.append(_Event(spin, marks[1] + off + 500 * ms, ms))
    got = trace.reduce(_profile(events), marks, [("item", marks[0] + ms, marks[1])])
    assert got.window_s == pytest.approx(0.999)
    assert got.busy_s == pytest.approx(0.5)
    assert len(got.gaps) == 3
