"""Neural speaker diarization (counterpart of audiolab_tpu/models/diarize.py;
reference: pyannote/speaker-diarization-3.1 via
modules/cloning/speaker_separation.py:24-209).

A two-stage system, as pyannote 3.1 is: a local end-to-end-neural
segmentation model producing per-frame activity for up to K speakers per
chunk, then speaker-embedding clustering to stitch chunk-local speakers
into global identities:

  SegmentationNet  log-mel -> conv frontend -> BiLSTM x2 -> Linear ->
                   sigmoid activities (t, K); trainable with the standard
                   permutation-invariant BCE (pit_bce_loss)
  SpeakerEmbedder  log-mel -> conv stack -> attentive stats pooling ->
                   L2-normed embedding (x-vector role)
  NeuralDiarizer   10 s chunks, 5 s hop -> activities -> active regions ->
                   embeddings -> agglomerative clustering -> global turns

The nets are the repository's own (no upstream checkpoint), so parameter
names follow the flax modules; the LSTMs are torch's, each direction one
flax ``OptimizedLSTMCell`` (utils/weights.py::diarize_from_jax).  The
checkpoint-compatible wespeaker r-vector (models/wespeaker.py) can take
the embedding stage and pyannote's PyanNet (models/pyannet.py) the
segmentation stage.  Random weights run the full path; converted or trained weights give real
accuracy.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig, powerset_to_multilabel
from audiolab_tpu_torch.models.wespeaker import wespeaker_embed
from audiolab_tpu_torch.utils.fast_init import fast_init


@dataclass(frozen=True)
class DiarizeConfig:
    sr: int = 16000
    n_mels: int = 64
    hop: int = 160               # 10 ms frames
    max_speakers: int = 3        # local speakers per chunk (pyannote K=3)
    hidden: int = 128
    emb_dim: int = 192
    chunk_s: float = 10.0
    chunk_hop_s: float = 5.0
    threshold: float = 0.5
    min_turn_s: float = 0.25
    cluster_threshold: float = 0.7   # cosine distance for agglomeration


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # flax nn.gelu's default


def _conv(cin: int, cout: int, dilation: int = 1) -> nn.Conv1d:
    """flax Conv(k=5, padding SAME) over NTC as an NCT conv."""
    return nn.Conv1d(cin, cout, 5, padding=2 * dilation, dilation=dilation)


class BiLSTM(nn.LSTM):
    """One bidirectional LSTM layer over (b, t, c) -> (b, t, 2 * hidden)."""

    def __init__(self, cin: int, hidden: int):
        super().__init__(cin, hidden, batch_first=True, bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]


class SegmentationNet(nn.Module):
    """(b, t, n_mels) log-mel -> (b, t, K) speaker activities in [0,1]."""

    def __init__(self, cfg: DiarizeConfig):
        super().__init__()
        c = cfg
        self.conv1 = _conv(c.n_mels, c.hidden)
        self.conv2 = _conv(c.hidden, c.hidden)
        self.lstm1 = BiLSTM(c.hidden, c.hidden)
        self.lstm2 = BiLSTM(2 * c.hidden, c.hidden)
        self.fc1 = nn.Linear(2 * c.hidden, c.hidden)
        self.fc2 = nn.Linear(c.hidden, c.max_speakers)

    def forward(self, mel):
        h = _gelu(self.conv1(mel.transpose(1, 2)))
        h = _gelu(self.conv2(h)).transpose(1, 2)
        h = self.lstm2(self.lstm1(h))
        return torch.sigmoid(self.fc2(_gelu(self.fc1(h))))


class SpeakerEmbedder(nn.Module):
    """(b, t, n_mels) -> (b, emb_dim) L2-normalized (x-vector role)."""

    def __init__(self, cfg: DiarizeConfig):
        super().__init__()
        c = cfg
        cin = c.n_mels
        for i, d in enumerate((1, 2, 3)):
            setattr(self, f"conv{i}", _conv(cin, c.hidden, d))
            cin = c.hidden
        self.attn = nn.Linear(c.hidden, 1)
        self.proj = nn.Linear(2 * c.hidden, c.emb_dim)

    def forward(self, mel, mask=None):
        h = mel.transpose(1, 2)
        for i in range(3):
            h = _gelu(getattr(self, f"conv{i}")(h))
        h = h.transpose(1, 2)                                     # (b, t, hidden)
        # attentive stats pooling: learned frame weights + weighted mu/sigma
        w = self.attn(torch.tanh(h))[..., 0]                      # (b, t)
        if mask is not None:
            w = torch.where(mask > 0, w, torch.full_like(w, -1e9))
        a = torch.softmax(w, dim=-1)[..., None]
        mu = (a * h).sum(dim=1)
        var = (a * (h - mu[:, None]) ** 2).sum(dim=1)
        e = self.proj(torch.cat([mu, torch.sqrt(var + 1e-6)], dim=-1))
        return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-6)


def pit_bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Permutation-invariant BCE over the K speaker channels (EEND loss):
    min over channel permutations of mean BCE.  pred/target (b, t, K)."""
    k = pred.shape[-1]
    eps = 1e-7
    losses = []
    for perm in permutations(range(k)):
        p = pred[..., list(perm)]
        bce = -(target * torch.log(p + eps) + (1.0 - target) * torch.log(1.0 - p + eps))
        losses.append(bce.mean(dim=(1, 2)))
    return torch.stack(losses).min(dim=0).values.mean()


# ------------------------------------------------------------ pipeline

class NeuralDiarizer:
    """The two nets on ``device`` (default the card; raises without one);
    without nets given, each gets weights by bench.py's rules from
    ``seed`` (``seed + 1`` for the embedder).  ``wespeaker``: a
    :class:`~audiolab_tpu_torch.models.wespeaker.WeSpeakerResNet` (moved to
    ``device``) whose r-vectors of the raw region audio replace the
    SpeakerEmbedder's, as pyannote speaker-diarization-3.1 embeds.
    ``pyannet_params``: a PyanNet state_dict under pyannote
    segmentation-3.0's names (with ``pyannet_cfg``, default
    ``PyanNetConfig()``): its powerset activities, mapped nearest-frame from
    its 270-sample frames onto the mel grid, replace the SegmentationNet's."""

    def __init__(self, cfg: DiarizeConfig | None = None,
                 seg: SegmentationNet | None = None, emb: SpeakerEmbedder | None = None,
                 seed: int = 0, pyannet_params=None, pyannet_cfg: PyanNetConfig | None = None,
                 wespeaker=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or DiarizeConfig()
        with self.device:
            seg = seg if seg is not None else fast_init(SegmentationNet(self.cfg), seed)
            emb = emb if emb is not None else fast_init(SpeakerEmbedder(self.cfg), seed + 1)
        self.seg = seg.to(self.device).eval()
        self.emb = emb.to(self.device).eval()
        self.wespeaker = None if wespeaker is None else wespeaker.to(self.device).eval()
        self.pyannet = None
        if pyannet_params is not None:
            with self.device:
                self.pyannet = PyanNet(pyannet_cfg or PyanNetConfig())
            self.pyannet.load_state_dict(pyannet_params, strict=True)
            self.pyannet.eval()

    def _mel(self, wav: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        m = mel_spectrogram(wav, sr=c.sr, n_fft=1024, hop=c.hop, n_mels=c.n_mels)
        return torch.log(torch.clamp(m, min=1e-5))

    @torch.inference_mode()
    def activities(self, batch: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
        """(B, chunk) audio -> (activities (B, t, K) on the host, log-mel
        (B, t, n_mels) on the device)."""
        wav = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)
        mel = self._mel(wav)
        if self.pyannet is None:
            return self.seg(mel).float().cpu().numpy(), mel
        ml = powerset_to_multilabel(self.pyannet(wav)).cpu().numpy()     # (B, tp, 3)
        # PyanNet's 270-sample frames onto the mel (hop) grid, nearest frame
        tp, tm = ml.shape[1], mel.shape[1]
        idx = np.minimum(np.arange(tm) * tp // max(tm, 1), tp - 1)
        return ml[:, idx, : self.cfg.max_speakers], mel

    def diarize(self, wav: np.ndarray, sr: int) -> list[tuple[float, float, str]]:
        """-> [(start_s, end_s, 'SPEAKER_00'), ...] like pyannote turns."""
        c = self.cfg
        if sr != c.sr:
            wav = resample_poly_np(np.asarray(wav, np.float32), sr, c.sr)
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        chunk = int(c.chunk_s * c.sr)
        hop = int(c.chunk_hop_s * c.sr)
        n = len(wav)
        starts = list(range(0, max(1, n - chunk + 1), hop))
        if not starts or starts[-1] + chunk < n:
            starts.append(max(0, n - chunk))
        # pad the tail so every chunk is full-size: one shape for the batch
        pads = np.zeros(chunk, np.float32)
        batch = np.stack([
            np.concatenate([wav[s:s + chunk], pads])[:chunk] for s in starts
        ])
        act, mel = self.activities(batch)

        frame_s = c.hop / c.sr
        regions = []
        rows, masks = [], []
        for bi, s in enumerate(starts):
            off = s / c.sr
            for k in range(c.max_speakers):
                a = act[bi, :, k] > c.threshold
                # valid frames only (tail chunk may be padded)
                t_valid = min(a.shape[0], int((n - s) / c.hop))
                a = a[:t_valid]
                edges = np.flatnonzero(np.diff(np.concatenate(
                    [[0], a.astype(np.int8), [0]])))
                for r0, r1 in zip(edges[::2], edges[1::2]):
                    if (r1 - r0) * frame_s < c.min_turn_s:
                        continue
                    regions.append((off + r0 * frame_s, off + r1 * frame_s))
                    mask = np.zeros(mel.shape[1], np.float32)
                    mask[r0:r1] = 1.0
                    rows.append(bi)
                    masks.append(mask)
        if not regions:
            return []
        if self.wespeaker is not None:
            embs = self._wespeaker_embs(wav, regions)
        else:
            with torch.inference_mode():
                embs = self.emb(mel[torch.as_tensor(rows, device=self.device)],
                                torch.from_numpy(np.stack(masks)).to(self.device))
        labels = _agglomerate(embs.float().cpu().numpy(), self.cfg.cluster_threshold)
        turns = sorted(
            (r0, r1, f"SPEAKER_{labels[i]:02d}")
            for i, (r0, r1) in enumerate(regions))
        return _merge_turns(turns)


    def _wespeaker_embs(self, wav: np.ndarray, regions: list[tuple[float, float]],
                        window_s: float = 3.0) -> torch.Tensor:
        """r-vectors of the regions: each region's raw audio wrap-padded or
        cropped to one window of ``window_s`` (one shape for every region,
        as pyannote crops around each local speaker's support)."""
        win = int(window_s * self.cfg.sr)
        segs = []
        for r0, r1 in regions:
            s0 = max(0, int(r0 * self.cfg.sr))
            s1 = min(len(wav), max(s0 + 1, int(r1 * self.cfg.sr)))
            segs.append(np.resize(wav[s0:s1], win))       # wrap-pads short regions
        return wespeaker_embed(self.wespeaker, np.stack(segs), sr=self.cfg.sr)


def _agglomerate(embs: np.ndarray, threshold: float) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance."""
    n = len(embs)
    clusters = [[i] for i in range(n)]
    means = [embs[i].copy() for i in range(n)]
    while len(clusters) > 1:
        m = np.stack([v / max(np.linalg.norm(v), 1e-9) for v in means])
        d = 1.0 - m @ m.T
        np.fill_diagonal(d, np.inf)
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if d[i, j] > threshold:
            break
        clusters[i].extend(clusters[j])
        means[i] = embs[clusters[i]].mean(axis=0)
        del clusters[j], means[j]
    labels = np.zeros(n, np.int64)
    for ci, members in enumerate(clusters):
        labels[members] = ci
    return labels


def _merge_turns(turns: list[tuple[float, float, str]],
                 gap: float = 0.2) -> list[tuple[float, float, str]]:
    """Merge overlapping/adjacent same-speaker turns (chunk overlap dedup)."""
    out: list[list] = []
    for t0, t1, spk in turns:
        if out and out[-1][2] == spk and t0 <= out[-1][1] + gap:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1, spk])
    return [(round(a, 3), round(b, 3), s) for a, b, s in out]
