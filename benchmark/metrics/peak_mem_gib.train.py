"""The training window's peak device memory (max_memory_allocated, reset at
the window's start), GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.device["platform"] == "gpu" else None
