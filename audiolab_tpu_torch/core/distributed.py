"""Multi-process setup (counterpart of audiolab_tpu/core/distributed.py;
reference: single-node DDP over NCCL with an environment rendezvous,
train.py:265-303).

:func:`init_distributed` starts the default ``torch.distributed`` process
group when its arguments or torchrun's environment ask for more than one
process, and is a no-op for one process.  The backend is NCCL with one rank
per card, each rank on the card its local rank names; gloo only when the
caller asks for it (several ranks may then share a card: gloo carries CUDA
tensors through ``all_reduce`` and ``broadcast``) or for the CPU.

:func:`run_ranks` starts ranks as spawned processes of this one (the dry
run's and the tests' launcher; torchrun starts them for a trainer).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_DEVICE: torch.device | None = None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: str | torch.device = "cuda",
                     init_method: str | None = None,
                     timeout: float | None = None) -> dict:
    """Join (or start) the default process group when the arguments or the
    environment say there is more than one process.

    Settings, explicit arguments first: ``init_method`` (e.g. a
    ``file://`` store) or ``coordinator`` ("host:port", taken as
    ``tcp://``), else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``;
    ``num_processes`` else ``WORLD_SIZE``; ``process_id`` else ``RANK``;
    the local rank from ``LOCAL_RANK``, else the rank.  With neither
    arguments nor environment this is a single-process no-op.

    ``device`` "cuda" (the default) takes NCCL, one rank per card, and sets
    the rank's card; ``backend="gloo"`` puts rank r on card r modulo the
    card count instead.  ``device="cpu"`` takes gloo.  Raises without a
    card when one is asked for, and under NCCL when the host has fewer
    cards than the local rank needs.  ``timeout``: seconds a collective
    waits.  Returns the JAX package's summary: process_index,
    process_count, local_devices, global_devices."""
    global _DEVICE
    env = os.environ
    world = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if init_method is None and coordinator:
        init_method = f"tcp://{coordinator}"
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    dev = torch.device(device)
    if dist.is_initialized():
        pass
    elif init_method is not None or (world or 1) > 1:
        if init_method is None:
            raise ValueError("init_distributed: more than one process needs an init_method, "
                             "a coordinator or MASTER_ADDR / MASTER_PORT")
        world = world or 1
        local = int(env.get("LOCAL_RANK", rank))
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks "
                                   "on the CPU")
            cards = torch.cuda.device_count()
            if backend == "nccl" and local >= cards:
                raise RuntimeError(f"NCCL takes one rank per card: local rank {local} "
                                   f"needs {local + 1} cards, the host has {cards}")
            dev = torch.device("cuda", local % cards)
            torch.cuda.set_device(dev)
        elif backend == "nccl":
            raise ValueError("NCCL needs the card: take backend='gloo' for the CPU")
        kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, **kw)
        log.info("torch.distributed initialised (%s): process %d/%d on %s",
                 backend, rank, world, dev)
    if dist.is_initialized():
        _DEVICE = dev if dev.type == "cpu" or dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
                "local_devices": 1, "global_devices": dist.get_world_size()}
    local_devices = max(torch.cuda.device_count(), 1) if dev.type == "cuda" else 1
    return {"process_index": 0, "process_count": 1, "local_devices": local_devices,
            "global_devices": local_devices}


def rank_device() -> torch.device:
    """The device :func:`init_distributed` gave this rank (the CPU before
    any group started)."""
    return _DEVICE or torch.device("cpu")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def average_gradients(params, group=None) -> None:
    """Replace each gradient by its mean over the group's ranks: one
    ``all_reduce`` of all of them flattened together.  Every rank must hold
    a gradient for the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    n = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _host(value):
    """``value`` with every tensor as a numpy array (sent by value)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    return value


def _rank_main(fn, rank: int, args: tuple, threads: int | None, results) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        results.put((rank, True, _host(fn(rank, *args))))
    except BaseException:  # noqa: BLE001 - the parent raises it with its traceback
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, nprocs: int, args: tuple = (), timeout: float = 600.0,
              threads: int | None = None) -> list:
    """Runs ``fn(rank, *args)`` in ``nprocs`` spawned processes (``fn`` a
    module-level function; each rank calls :func:`init_distributed`
    itself) and returns their return values by rank, tensors as numpy
    arrays.  ``threads``: torch's CPU threads in each child (by default the
    process's cores shared out among the ranks: more would oversubscribe
    them, and a rank's CPU ops would stall in its OpenMP pool).  A rank that
    raises fails the call with its traceback; ranks still running after
    ``timeout`` seconds are terminated and the call raises
    ``TimeoutError``.  Every process is ended on return."""
    if threads is None:
        threads = max(1, len(os.sched_getaffinity(0)) // nprocs)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, args, threads, results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(out))} still "
                                   f"running after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(nprocs)]


def rows(x: torch.Tensor | np.ndarray, index: int, count: int):
    """Rows ``index`` of ``count`` equal parts of ``x``'s first axis (a
    rank's shard of a global batch); raises when they do not divide it."""
    n = x.shape[0]
    if n % count:
        raise ValueError(f"a batch of {n} does not split into {count} equal shards")
    per = n // count
    return x[index * per:(index + 1) * per]
