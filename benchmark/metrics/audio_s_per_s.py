"""Seconds of input audio the window finished, over the window's seconds
(host clock, from the first song's hand-over to the end of the last)."""


def read(run):
    return run.units("audio_s") / run.window_s
