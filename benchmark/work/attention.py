"""Attention calls of the program's models and each call's work, from
shapes: products 4*b*h*tq*tk*d (q.k and p.v), each input byte read once and
each output byte written once."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Call:
    kernel: str        # "K1" (one key block, not causal) or "K2" (flash)
    bh: int            # batch x heads
    tq: int
    tk: int
    d: int
    elem_bytes: int    # bytes of one element of q, k, v and the output

    @property
    def flops(self) -> float:
        return 4.0 * self.bh * self.tq * self.tk * self.d

    @property
    def bytes(self) -> float:
        return float(self.elem_bytes * self.bh * self.d * (2 * self.tq + 2 * self.tk))

    def roofline_s(self, peak_flops: float, peak_bytes: float) -> float:
        """The least time the card could take: the larger of the products
        over the peak rate and the bytes over the bandwidth."""
        return max(self.flops / peak_flops, self.bytes / peak_bytes)


def stft_frames(samples: int, hop: int) -> int:
    return 1 + samples // hop        # centred STFT


def roformer_calls(sep: dict, b: int) -> list[Call]:
    """One BS-RoFormer forward on a batch of ``b`` chunks: at every depth
    step, attention over time (b * bands sequences of the chunk's frames)
    and over bands (b * frames sequences of the bands), ``heads`` heads of
    ``dim_head``, in the activation type (2 bytes for bf16)."""
    t = stft_frames(int(sep["chunk_s"] * sep["sr"]), sep["hop"])
    nb = len(sep["freqs_per_bands"])
    h, d = sep["heads"], sep["dim_head"]
    eb = 2 if sep["dtype"] in ("bfloat16", "float16") else 4
    return [Call("K1", b * nb * h, t, t, d, eb), Call("K1", b * t * h, nb, nb, d, eb)] \
        * sep["depth"]


def hubert_frames(samples: int) -> int:
    """Frames of HuBERT's conv front end (kernels 10, 3 x 4, 2 x 2; strides
    5, 2 x 6)."""
    n = samples
    for k, s in [(10, 5)] + [(3, 2)] * 4 + [(2, 2)] * 2:
        n = (n - k) // s + 1
    return n


def hubert_calls(conv: dict, b: int) -> list[Call]:
    """HuBERT on a group of ``b`` 16 kHz chunks: fp32 self-attention in each
    layer."""
    chunk = int(conv["chunk_s"] * 16000)
    chunk -= chunk % 320
    t = hubert_frames(chunk)
    hub = conv["hubert"]
    return [Call("K2", b * hub["heads"], t, t, hub["dim"] // hub["heads"], 4)] * hub["layers"]
