"""wav2vec2-CTC forced aligner: WhisperX-style word timings (counterpart of
audiolab_tpu/models/wav2vec2.py).

wav2vec2-base and HuBERT-base share the encoder topology, so the backbone
is the port's ``models.hubert.Hubert`` run to its last layer (12 fp32 K2
launches a segment on the card at ``HubertConfig()``) and the CTC head is
``lm_head``.  Each transcribed segment is aligned on its own at its own
length (20 ms frames): the JAX package compiles once per length, the port
runs eagerly.  The trellis is the host code of
``pipelines/forced_align.py``.  ``utils/weights.py::wav2vec2_to_hf`` names
the port's parameters as HF ``Wav2Vec2ForCTC``'s, the names
``convert_wav2vec2`` reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.hubert import Hubert, HubertConfig
from audiolab_tpu_torch.pipelines.forced_align import ctc_forced_align, energy_align_words
from audiolab_tpu_torch.utils.fast_init import fast_init

# facebook/wav2vec2-base-960h vocabulary (uppercase chars, | = word break,
# <pad> doubles as the CTC blank, the HF convention)
CTC_VOCAB_EN = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6,
    "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12, "R": 13, "D": 14,
    "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20, "G": 21, "Y": 22,
    "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28, "J": 29, "Q": 30,
    "Z": 31,
}


@dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32
    encoder: HubertConfig = field(default_factory=HubertConfig)


class Wav2Vec2CTC(nn.Module):
    """HF Wav2Vec2ForCTC's function: wav (b, n) 16 kHz -> logits (b, t, V)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Hubert(cfg.encoder)
        self.lm_head = nn.Linear(cfg.encoder.dim, cfg.vocab_size)

    def forward(self, wav):
        return self.lm_head(self.encoder(wav, output_layer=self.cfg.encoder.layers))


class CTCWordAligner:
    """Segment transcript -> word timings by CTC forced alignment, with the
    model on ``device`` (default the card; raises without one)."""

    FRAME_S = 320.0 / 16000.0  # one encoder frame = 20 ms

    def __init__(self, model: Wav2Vec2CTC, vocab: dict[str, int] | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.vocab = vocab or CTC_VOCAB_EN
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def log_probs(self, seg: np.ndarray) -> np.ndarray:
        """(n,) 16 kHz -> (t, vocab) fp32 log-softmax of the CTC logits."""
        wav = torch.from_numpy(np.ascontiguousarray(seg, np.float32))[None].to(self.device)
        return torch.log_softmax(self.model(wav)[0].float(), dim=-1).cpu().numpy()

    def _encode_words(self, words: list[str]) -> tuple[np.ndarray, list[int]]:
        """chars -> ids with | separators; returns (ids, per-token word idx)."""
        ids: list[int] = []
        owner: list[int] = []
        unk = self.vocab.get("<unk>", 3)
        sep = self.vocab.get("|", 4)
        for wi, w in enumerate(words):
            if wi:
                ids.append(sep)
                owner.append(-1)
            for ch in w.upper():
                ids.append(self.vocab.get(ch, unk))
                owner.append(wi)
        return np.asarray(ids, np.int64), owner

    def align_words(self, audio: np.ndarray, sr: int, start: float,
                    end: float, words: list[str]) -> list[dict]:
        words = [w for w in (w.strip() for w in words) if w]
        if not words:
            return []
        i0 = max(0, int(start * sr))
        i1 = min(len(audio), int(end * sr))
        seg = np.asarray(audio[i0:i1], np.float32)
        if len(seg) < sr // 25:  # < 40 ms: no frames to align
            return energy_align_words(audio, sr, start, end, words)
        lp = self.log_probs(seg)
        ids, owner = self._encode_words(words)
        spans = ctc_forced_align(lp, ids, blank=self.vocab.get("<pad>", 0))
        out = []
        for wi, w in enumerate(words):
            tok = [spans[k] for k in range(len(ids)) if owner[k] == wi]
            if not tok:
                continue
            s = start + tok[0][0] * self.FRAME_S
            e = start + tok[-1][1] * self.FRAME_S
            out.append({"word": w, "start": round(s, 3),
                        "end": round(max(e, s + self.FRAME_S), 3)})
        return out


def random_ctc_aligner(seed: int = 0, vocab_size: int = 32, layers: int = 2,
                       device: str | torch.device = "cuda") -> CTCWordAligner:
    """Random-weight aligner (the JAX package's tiny encoder: dim 64, 4
    heads) on ``device`` (default the card), weights by utils/fast_init's
    rules from ``seed``."""
    dev = resolve_device(device)
    cfg = Wav2Vec2Config(vocab_size=vocab_size,
                         encoder=HubertConfig(dim=64, ffn_dim=128, heads=4, layers=layers))
    with dev:
        model = fast_init(Wav2Vec2CTC(cfg), seed)
    return CTCWordAligner(model, device=dev)
