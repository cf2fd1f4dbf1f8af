"""Real-time lyric alignment: frame classifiers and online DTW (counterpart
of audiolab_tpu/models/rtla.py; reference modules/rtla/).

- ``CRNN``: conv blocks (3x3, flax-style LayerNorm over channels, ReLU,
  max-pool over frequency) and a GRU over time whose candidate is
  ``tanh(W [x, r * h] + b)`` (reset gate before the product, unlike
  ``nn.GRU``), so it is three ``Linear`` gates ``wz``, ``wr``, ``wn``
  stepped in a loop.  Names are the JAX tree's (no upstream checkpoint).
- ``RtlaCRNN``: the RTLA checkpoint's frame classifier under its own names
  (``model.0.cnn.N``, ``model.0.fc.0``, ``model.1.rnn``, ``model.2``):
  ConvStack with torch BatchNorms on running statistics, channel-major
  flatten, a uni-directional ``nn.LSTM``, a linear head.
- ``rtla_mel_db`` and ``phoneme_features`` (the CRNN front end and its
  posteriorgram stream) run on the device; ``chroma_features`` too.
- ``OLTW``, ``make_path_strictly_monotonic`` and ``StreamChunker`` are the
  JAX package's host code, copied: OLTW is sequential with O(window) work a
  frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.kernels.stft import spectrogram
from audiolab_tpu_torch.models.lm import model_device
from audiolab_tpu_torch.models.zonos import _flax_layer_norm


@dataclass(frozen=True)
class CRNNConfig:
    n_mels: int = 80
    n_classes: int = 72        # phoneme classes (or 12 for chroma targets)
    conv_ch: tuple = (32, 32, 64)
    gru_dim: int = 128


class GRUCell(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.wz = nn.Linear(cin + dim, dim)
        self.wr = nn.Linear(cin + dim, dim)
        self.wn = nn.Linear(cin + dim, dim)

    def forward(self, h, x):
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(self.wz(xh))
        r = torch.sigmoid(self.wr(xh))
        n = torch.tanh(self.wn(torch.cat([x, r * h], dim=-1)))
        return (1 - z) * n + z * h


class CRNN(nn.Module):
    def __init__(self, cfg: CRNNConfig = CRNNConfig()):
        super().__init__()
        c = self.cfg = cfg
        cin, f = 1, c.n_mels
        for i, ch in enumerate(c.conv_ch):
            setattr(self, f"conv_{i}", nn.Conv2d(cin, ch, 3, padding=1))
            setattr(self, f"ln_{i}", nn.LayerNorm(ch, eps=1e-6))
            cin, f = ch, f // 2
        self.gru = GRUCell(cin * f, c.gru_dim)
        self.head = nn.Linear(c.gru_dim, c.n_classes)

    def forward(self, mel):
        """(b, t, n_mels) -> frame log-posteriors (b, t, n_classes)."""
        h = mel[:, None]                                        # (b, 1, t, F)
        for i in range(len(self.cfg.conv_ch)):
            h = getattr(self, f"conv_{i}")(h).permute(0, 2, 3, 1)   # (b, t, F, ch)
            h = F.relu(_flax_layer_norm(h, getattr(self, f"ln_{i}"))).permute(0, 3, 1, 2)
            h = F.max_pool2d(h, (1, 2))
        b, ch, t, f = h.shape
        seq = h.permute(0, 2, 3, 1).reshape(b, t, f * ch)       # the flax (f, ch) order
        state = seq.new_zeros(b, self.cfg.gru_dim)
        outs = []
        for j in range(t):
            state = self.gru(state, seq[:, j])
            outs.append(state)
        return torch.log_softmax(self.head(torch.stack(outs, dim=1)), dim=-1)


@dataclass(frozen=True)
class RtlaCRNNConfig:
    """The published pretrained-model.safetensors hyperparameters come from
    its sibling pretrained-model.json (modules/rtla/utils.py:30-39)."""

    n_mels: int = 66              # modules/rtla/config.py N_MELS
    num_lbl: int = 72             # phoneme classes (config.num_lbl)
    model_complexity: int = 16    # model_size = 16 * complexity

    @property
    def model_size(self) -> int:
        return self.model_complexity * 16


class _ConvStack(nn.Module):
    def __init__(self, cfg: RtlaCRNNConfig):
        super().__init__()
        ms = cfg.model_size
        self.cnn = nn.Sequential(
            nn.Conv2d(1, ms // 16, 3, padding=1), nn.BatchNorm2d(ms // 16), nn.ReLU(),
            nn.Conv2d(ms // 16, ms // 16, 3, padding=1), nn.BatchNorm2d(ms // 16), nn.ReLU(),
            nn.MaxPool2d((1, 2)), nn.Dropout(0.25),
            nn.Conv2d(ms // 16, ms // 8, 3, padding=1), nn.BatchNorm2d(ms // 8), nn.ReLU(),
            nn.MaxPool2d((1, 2)), nn.Dropout(0.25))
        self.fc = nn.Sequential(nn.Linear(ms // 8 * (cfg.n_mels // 4), ms), nn.Dropout(0.5))

    def forward(self, feat):
        x = self.cnn(feat[:, None])                  # (b, C, t, F')
        return self.fc(x.transpose(1, 2).flatten(-2))  # channel-major: c * F' + f


class _Rnn(nn.Module):
    def __init__(self, ms: int):
        super().__init__()
        self.rnn = nn.LSTM(ms, ms, batch_first=True)

    def forward(self, x):
        return self.rnn(x)[0]


class RtlaCRNN(nn.Module):
    """The RTLA frame classifier (reference modules/rtla/CRNN_model.py:63-160):
    (b, t, n_mels) mel-dB features -> frame logits (b, t, num_lbl)."""

    def __init__(self, cfg: RtlaCRNNConfig = RtlaCRNNConfig()):
        super().__init__()
        self.cfg = cfg
        ms = cfg.model_size
        self.model = nn.Sequential(_ConvStack(cfg), _Rnn(ms), nn.Linear(ms, cfg.num_lbl))

    def forward(self, feat):
        return self.model(feat)


def rtla_mel_db(wav: np.ndarray, sr: int = 16000, n_mels: int = 66, hop: int = 640,
                top_db: float = 80.0, device: str | torch.device = "cuda") -> torch.Tensor:
    """The RTLA CRNN front end: power mel, n_fft = 2 * hop, center=False,
    unit-peak (inf-norm) filters, AmplitudeToDB(power, top_db) from the
    global max.  wav (n,) -> (t, n_mels) on ``device`` (default the card;
    raises without one)."""
    w = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(resolve_device(device))
    m = mel_spectrogram(w[None], sr=sr, n_fft=2 * hop, hop=hop, n_mels=n_mels, norm="inf",
                        power=2.0, center=False)[0]
    db = 10.0 * torch.log10(torch.clamp(m, min=1e-10))
    return torch.maximum(db, db.max() - top_db)


@torch.inference_mode()
def phoneme_features(wav: np.ndarray, sr: int, model: RtlaCRNN, hop: int = 640,
                     temperature: float = 1.0,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Phoneme posteriorgram stream for OLTW (reference
    modules/rtla/utils.py:94-106 process_phonemes): CRNN frame logits ->
    softmax(T) -> log1p(p * 5) / 4; returns (C, T) on the host.  ``model``
    must be on ``device`` (default the card; raises without one)."""
    dev, _ = model_device(model, device, False, "phoneme_features")
    if sr != 16000:
        wav = resample_poly_np(np.asarray(wav, np.float32), sr, 16000)
        sr = 16000
    feat = rtla_mel_db(np.asarray(wav, np.float32), sr=sr, n_mels=model.cfg.n_mels, hop=hop,
                       device=dev)
    p = torch.softmax(model.eval()(feat[None])[0] / temperature, dim=-1)
    ph = (torch.log1p(p * 5.0) / 4.0).T.cpu().numpy()       # (C, T)
    return ph[:, 1:-1] if ph.shape[1] > 2 else ph           # trim context frames


# ------------------------------------------------------------------ OLTW

class OLTW:
    """Online DTW (oltw.py semantics): align a stream of feature frames to a
    reference sequence with a bounded window and run-length constraints."""

    def __init__(self, ref: np.ndarray, window: int = 64, max_run: int = 3,
                 metric: str = "cosine"):
        self.ref = np.ascontiguousarray(ref, np.float32)   # (n_ref, d)
        if metric == "cosine":
            norms = np.linalg.norm(self.ref, axis=1, keepdims=True) + 1e-8
            self.ref_n = self.ref / norms
        self.metric = metric
        self.window = window
        self.max_run = max_run
        self.n_ref = len(ref)
        self.j = 0                    # current reference index
        self.t = 0                    # current stream index
        self.run = 0
        self.last_dir = None
        big = np.float32(1e9)
        self.D = np.full((self.n_ref,), big, np.float32)   # rolling column
        self.D_prev = np.full((self.n_ref,), big, np.float32)
        self.path: list[tuple[int, int]] = []

    def _dist_col(self, x: np.ndarray) -> np.ndarray:
        lo = max(0, self.j - self.window)
        hi = min(self.n_ref, self.j + self.window)
        seg = self.ref_n[lo:hi] if self.metric == "cosine" else self.ref[lo:hi]
        if self.metric == "cosine":
            xn = x / (np.linalg.norm(x) + 1e-8)
            d = 1.0 - seg @ xn
        else:
            d = np.linalg.norm(seg - x, axis=1)
        col = np.full((self.n_ref,), 1e9, np.float32)
        col[lo:hi] = d
        return col

    def insert(self, x: np.ndarray) -> int:
        """Feed one stream frame; returns current reference position."""
        d = self._dist_col(np.asarray(x, np.float32))
        lo = max(0, self.j - self.window)
        hi = min(self.n_ref, self.j + self.window)
        newD = np.full_like(self.D, 1e9)
        if self.t == 0:
            newD[lo:hi] = np.cumsum(d[lo:hi])
        else:
            for jj in range(lo, hi):
                best = self.D[jj]                       # (t-1, j) step right
                if jj > 0:
                    best = min(best, self.D[jj - 1])    # (t-1, j-1) diagonal
                    best = min(best, newD[jj - 1])      # (t, j-1) step down
                newD[jj] = d[jj] + best
        self.D_prev = self.D
        self.D = newD
        # advance reference pointer toward the window minimum, bounded by
        # the run-length constraint (no more than max_run pure advances)
        jmin = int(np.argmin(self.D[lo:hi])) + lo
        if jmin > self.j:
            if self.last_dir == "ref" and self.run >= self.max_run:
                self.run = 0
                self.last_dir = "stream"
            else:
                self.j = min(self.j + 1, self.n_ref - 1)
                self.run = self.run + 1 if self.last_dir == "ref" else 1
                self.last_dir = "ref"
        else:
            self.run = self.run + 1 if self.last_dir == "stream" else 1
            self.last_dir = "stream"
        self.t += 1
        self.path.append((self.t - 1, self.j))
        return self.j

    def align(self, stream: np.ndarray) -> np.ndarray:
        """Offline convenience: feed all frames; returns (t, 2) path."""
        for x in stream:
            self.insert(x)
        return np.asarray(self.path)


def make_path_strictly_monotonic(path: np.ndarray) -> np.ndarray:
    """Deduplicate so both coordinates strictly increase (utils.py)."""
    out = [path[0]]
    for t, j in path[1:]:
        lt, lj = out[-1]
        if t > lt and j > lj:
            out.append((t, j))
    return np.asarray(out)


class StreamChunker:
    """Mock real-time chunker (stream_processor.py:64): yields fixed hops."""

    def __init__(self, wav: np.ndarray, sr: int, hop_s: float = 0.04):
        self.wav = np.asarray(wav, np.float32)
        self.hop = int(hop_s * sr)

    def __iter__(self):
        for s in range(0, len(self.wav) - self.hop + 1, self.hop):
            yield self.wav[s: s + self.hop]


# ------------------------------------------------------------------ chroma

CHROMA_A4 = 440.0


def chroma_features(wav: np.ndarray, sr: int, hop: int = 512, n_fft: int = 2048,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """12-bin chroma from an STFT magnitude taken on ``device`` (default the
    card; raises without one); (t, 12) on the host."""
    dev = resolve_device(device)
    w = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(dev)
    mag = spectrogram(w[None], n_fft, hop, center=True, power=1.0)[0].cpu().numpy()
    freqs = np.linspace(0, sr / 2, mag.shape[1])
    chroma = np.zeros((mag.shape[0], 12), np.float32)
    valid = freqs > 30.0
    pitch = 12.0 * np.log2(np.maximum(freqs, 1e-3) / CHROMA_A4) + 69.0
    bins = np.round(pitch).astype(int) % 12
    for b in range(12):
        sel = valid & (bins == b)
        if sel.any():
            chroma[:, b] = mag[:, sel].sum(axis=1)
    norm = np.linalg.norm(chroma, axis=1, keepdims=True) + 1e-8
    return chroma / norm
