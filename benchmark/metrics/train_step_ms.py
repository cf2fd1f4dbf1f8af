"""The window's milliseconds over the training steps completed in it, the
loader's batches included (host clock)."""


def read(run):
    steps = run.units("steps")
    return None if steps == 0 else 1000.0 * run.window_s / steps
