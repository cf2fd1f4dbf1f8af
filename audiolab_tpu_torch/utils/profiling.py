"""Tracing and profiling utilities (counterpart of
audiolab_tpu/utils/profiling.py; reference: the ``times[]`` accumulators of
the RVC pipeline, pipeline.py:188,231-236, ``EpochRecorder``,
train.py:241-252, and the chain executor's elapsed-time report,
layouts/process.py:484-487).

- :class:`StageTimer`: per-stage seconds, synchronising the card when asked
  so that the numbers mean compute, not launch.
- :func:`trace`: a ``torch.profiler`` trace over the CPU and CUDA written to
  a directory as Chrome / TensorBoard trace files.
- :class:`EpochRecorder`: the per-epoch timing string.
- :func:`timed`: a decorator accumulating per-function seconds into the
  module-global timer, read by :func:`global_report`.

"Sync" means ``torch.cuda.synchronize`` on the device of each CUDA tensor
found in the object given (a tensor, or one nested in lists, tuples and
dicts); an object that holds no CUDA tensor needs none.  This is not
``models/lm.py::StageTimer``, which records the time since its previous call
into a caller's dict.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from functools import wraps

import torch

log = logging.getLogger(__name__)


def _cuda_devices(obj, found: set) -> set:
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def block_until_ready(obj) -> None:
    """Wait for the card work that produced the CUDA tensors in ``obj``."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates per-stage seconds; syncs device work when asked so the
    numbers mean compute, not dispatch."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: object | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                block_until_ready(sync)
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        parts = [
            f"{k}: {v:.3f}s ({self.counts[k]}x)"
            for k, v in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        ]
        return f"total {total:.3f}s | " + ", ".join(parts)

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in self.seconds.items()}


@contextlib.contextmanager
def trace(logdir: str = "audiolab_trace"):
    """``torch.profiler`` over the CPU and (where there is one) the card
    around the block; on exit the trace is written into ``logdir`` as a
    ``*.pt.trace.json`` file that TensorBoard's profiler plugin and
    Perfetto open.  Yields ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield logdir


class EpochRecorder:
    """train.py:241-252 equivalent: 'elapsed 12.3s | epoch time 1.2s'."""

    def __init__(self):
        self.t_start = time.perf_counter()
        self.t_last = self.t_start

    def record(self) -> str:
        now = time.perf_counter()
        msg = (f"elapsed {now - self.t_start:.1f}s | "
               f"epoch time {now - self.t_last:.2f}s")
        self.t_last = now
        return msg


_GLOBAL = StageTimer()


def timed(name: str | None = None, sync: bool = True):
    """Decorator: accumulate wall seconds into the module-global timer,
    after waiting for the CUDA tensors of the result when ``sync``."""

    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                block_until_ready(out)
            _GLOBAL.seconds[label] += time.perf_counter() - t0
            _GLOBAL.counts[label] += 1
            return out

        return wrapper

    return deco


def global_report() -> str:
    return _GLOBAL.report()
