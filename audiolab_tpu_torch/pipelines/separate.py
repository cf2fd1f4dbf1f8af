"""Stem separation (counterpart of audiolab_tpu/pipelines/separate.py).

- :class:`StemSeparator`: each member runs on fixed-size chunk batches
  (core/chunking), the chunks are crossfade-stitched, and the members'
  vocals and instrumentals are blended (avg/median hybrid) and de-bled
  (residual subtraction with a cosine guard); or one N-stem member makes a
  multistem split whose stems sum to the input.  Everything stays on the
  separator's device.  With a ``mesh`` over the ranks of a process group
  (core/mesh.py) each batch of chunks is split over its ``dp`` axis: each
  rank runs its shard and the batch is assembled on every rank (an
  ``all_reduce`` of the shards laid in zeros).
- :func:`vr_split` / :func:`vr_transform`: a VR net as a named two-stem
  split (the karaoke background-vocal pass) or as a per-stem transform.
- The checkpoint-free DSP transforms of the per-stem chain (spectral gate,
  dereverb, HPSS) and their policy tables, on the given device in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.stft import istft, stft
from audiolab_tpu_torch.models.separation.vr_bands import VRSeparator


@dataclass
class EnsembleMember:
    """One separation model and its blend weights.  ``apply_fn`` maps a
    chunk batch (b, ch, n) to {stem: (b, ch, n)}; an ``nn.Module`` is moved
    to the separator's device."""

    name: str
    apply_fn: Callable[[torch.Tensor], dict]
    weight_vocals: float = 1.0
    weight_inst: float = 1.0


def _median(stack: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, the mean of the two middle values for an even
    count (numpy's and jnp's convention; torch.median takes the lower)."""
    s = stack.sort(dim=0).values
    m = s.shape[0]
    if m % 2:
        return s[m // 2]
    return 0.5 * (s[m // 2 - 1] + s[m // 2])


def blend_tracks(tracks: list, weights: list[float]) -> torch.Tensor:
    """Avg/median hybrid blend of (ch, n) tracks."""
    stack = torch.stack(list(tracks))
    w = torch.tensor(weights, dtype=torch.float32, device=stack.device)[:, None, None]
    avg = (stack * w).sum(0) / w.sum()
    return 0.5 * (avg + _median(stack))


def debleed(target: torch.Tensor, other: torch.Tensor, alpha: float = 0.2,
            cos_guard: float = 0.5) -> torch.Tensor:
    """Subtract ``alpha`` times the projection of ``target`` on ``other``,
    only where the stems are decorrelated (|cos| <= cos_guard)."""
    t, o = target.reshape(-1), other.reshape(-1)
    dot = torch.dot(t, o)
    cos = dot / (torch.linalg.norm(t) * torch.linalg.norm(o) + 1e-9)
    proj = dot / (torch.dot(o, o) + 1e-9)
    apply = (cos.abs() <= cos_guard).float()
    return target - apply * alpha * proj * other


class StemSeparator:
    """Chunked, batched ensemble separation on one device, or fanned out
    over a mesh's ``dp`` axis."""

    def __init__(self, members: list[EnsembleMember], sr: int = 44100,
                 chunk_seconds: float = 8.0, overlap_seconds: float = 0.5,
                 device_batch: int = 8, matmul_precision: str = "bfloat16",
                 device: str | torch.device = "cuda", mesh=None):
        """``mesh``: a ``core.mesh.Mesh`` over the ranks of a process
        group; chunk batches are split over its ``dp`` axis, and
        ``device_batch`` is raised to a multiple of dp so that every shard
        gets equal work.  Under a mesh the separator's device is the mesh's
        (the rank's).  A one-process mesh of more than one slot raises
        ``ValueError``: no rank runs its other shards."""
        if mesh is not None and mesh.shape["dp"] > 1 and not mesh.distributed:
            raise ValueError("the separator fans out over the ranks of a process group: "
                             "start one rank a card (init_distributed) and pass get_mesh()")
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.members = members
        for m in members:
            if isinstance(m.apply_fn, torch.nn.Module):
                m.apply_fn.to(self.device).eval()
        self.sr = sr
        self.chunk_seconds = chunk_seconds
        self.overlap_seconds = overlap_seconds
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            device_batch = max(device_batch, dp)
            device_batch += (-device_batch) % dp
        self.device_batch = device_batch
        self.matmul_precision = matmul_precision

    def _apply(self, member: EnsembleMember, batch: torch.Tensor) -> dict:
        """One chunk batch through the member, split over the mesh's dp:
        this rank's shard, the batch assembled on every rank."""
        dp = 1 if self.mesh is None else self.mesh.shape["dp"]
        if dp == 1:
            return member.apply_fn(batch)
        per = batch.shape[0] // dp
        c = self.mesh.coordinate("dp")
        out = member.apply_fn(batch[c * per:(c + 1) * per])
        full = {}
        for stem, v in out.items():
            full[stem] = v.new_zeros((dp * per,) + v.shape[1:])
            full[stem][c * per:(c + 1) * per] = v
            dist.all_reduce(full[stem], group=self.mesh.group("dp"))
        return full

    def _run_member(self, member: EnsembleMember, audio: torch.Tensor) -> dict:
        """Chunk -> fixed-size batched calls -> crossfade stitch."""
        ch, n = audio.shape
        plan = plan_chunks(n, int(self.chunk_seconds * self.sr),
                           int(self.overlap_seconds * self.sr))
        db = max(1, min(self.device_batch, plan.count))
        # balance the batch over the group count (35 chunks at batch 8 run
        # as 5 groups of 7, not 5 of 8 with 5 padded rows)
        n_groups = -(-plan.count // db)
        db = -(-plan.count // n_groups)
        if self.mesh is not None:   # keep shards equal across the dp axis
            dp = self.mesh.shape["dp"]
            db += (-db) % dp
        pad = (-plan.count) % db
        chunks = extract_chunks(audio, plan)                     # (count, ch, chunk)
        if pad:
            chunks = torch.cat([chunks, chunks.new_zeros((pad,) + chunks.shape[1:])])
        groups = [self._apply(member, chunks[g:g + db]) for g in range(0, chunks.shape[0], db)]
        # stems in key order, as the JAX separator's jitted member graph
        # returns them (the order of a multistem split's files)
        out = {s: torch.cat([gr[s] for gr in groups])[: plan.count] for s in sorted(groups[0])}
        return {s: stitch_chunks(v, plan) for s, v in out.items()}

    @torch.inference_mode()
    def separate(self, audio, callback=None, as_numpy: bool = True) -> dict:
        """(ch, n) -> {"vocals": (ch, n), "instrumental": (ch, n)}.
        ``as_numpy=False`` returns tensors on the device."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        if audio.dim() == 1:
            audio = audio[None]
        vocals_tracks, inst_tracks, wv, wi = [], [], [], []
        with precision.matmul_precision(self.matmul_precision):
            for i, m in enumerate(self.members):
                if callback:
                    callback(i, f"Separating with {m.name}", len(self.members))
                stems = self._run_member(m, audio)
                v = stems.get("vocals")
                inst = stems.get("other", stems.get("instrumental"))
                if inst is None and v is not None:
                    inst = audio - v
                if v is not None:
                    vocals_tracks.append(v)
                    wv.append(m.weight_vocals)
                if inst is not None:
                    inst_tracks.append(inst)
                    wi.append(m.weight_inst)
        vb = blend_tracks(vocals_tracks, wv)
        ib = blend_tracks(inst_tracks, wi)
        vocals, inst = debleed(vb, ib), debleed(ib, vb)
        if as_numpy:
            return {"vocals": vocals.float().cpu().numpy(),
                    "instrumental": inst.float().cpu().numpy()}
        return {"vocals": vocals, "instrumental": inst}

    @torch.inference_mode()
    def separate_multistem(self, audio, member: EnsembleMember, callback=None) -> dict:
        """Every stem of one N-stem member, (ch, n) each as numpy; the
        residual (input minus the sum of the stems) is folded into "other",
        so the stems sum to the input.  A derived "instrumental" stem is
        dropped when the member gives more than two stems (it would count
        twice in the residual)."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if callback:
            callback(0, f"Multistem with {member.name}", 1)
        out = self._run_member(member, torch.from_numpy(audio).to(self.device))
        stems = {k: v.float().cpu().numpy() for k, v in out.items()}
        if len(stems) > 2:
            stems.pop("instrumental", None)
        n = audio.shape[1]
        total = np.zeros_like(audio)
        for v in stems.values():
            total = total + v[:, :n]
        other = stems.get("other", np.zeros_like(audio))
        stems["other"] = (other[:, :n] + (audio - total)).astype(np.float32)
        return {k: np.asarray(v, np.float32) for k, v in stems.items()}


class _StemModel(nn.Module):
    """A separation net whose forward maps a chunk batch (b, ch, n) to
    {stem: (b, ch, n)}: the net's output (b, S, ch, n) named by ``names``,
    the input right-padded to a multiple of ``hop`` frames first when
    ``frame_multiple`` is set (and trimmed back), and the derived complement
    of a two-stem split (instrumental = mix - vocals, or the reverse)."""

    def __init__(self, model: nn.Module, names: list[str], hop: int = 0,
                 frame_multiple: int = 0):
        super().__init__()
        self.model, self.names = model, names
        self.hop, self.frame_multiple = hop, frame_multiple

    def forward(self, batch):
        n = batch.shape[-1]
        x = batch
        if self.frame_multiple:
            frames = -(-(n // self.hop + 1) // self.frame_multiple) * self.frame_multiple
            if (frames - 1) * self.hop < n:
                raise ValueError(f"a chunk of {n} samples has no padded length of "
                                 f"{frames} frames")
            x = F.pad(batch, (0, (frames - 1) * self.hop - n))
        out = self.model(x)[..., :n]
        stems = {s: out[:, i] for i, s in enumerate(self.names)}
        if "instrumental" not in stems and "vocals" in stems:
            stems["instrumental"] = batch - stems["vocals"]
        elif "vocals" not in stems and "instrumental" in stems:
            stems["vocals"] = batch - stems["instrumental"]
        return stems


def htdemucs_member(model, name: str = "htdemucs_6s", weight_vocals: float = 1.0,
                    weight_inst: float = 1.0) -> EnsembleMember:
    """An HTDemucs (models/separation/htdemucs.py) as an ensemble member that
    returns every source, and "instrumental" (mix - vocals) where no source
    has that name: for ``separate_multistem`` (the reference's 6-stem path)
    or a two-stem ensemble."""
    return EnsembleMember(name, _StemModel(model, list(model.cfg.sources)),
                          weight_vocals, weight_inst)


def mdx23c_member(model, name: str = "mdx23c", weight_vocals: float = 7.2,
                  weight_inst: float = 14.9) -> EnsembleMember:
    """An MDX23C (models/separation/mdx23c.py) as an ensemble member; the
    reference blends MDX23C-8KFFT-InstVoc_HQ at 7.2 / 14.9 and splits drum
    kits with the DrumSep variant.  Chunks are right-padded to the net's
    frame divisibility and trimmed back, so any chunk length works; stems
    are the instruments in lower case."""
    c = model.cfg
    names = [s.lower() for s in ([c.target_instrument] if c.target_instrument
                                 else c.instruments)]
    return EnsembleMember(name, _StemModel(model, names, c.hop_length,
                                           c.scale[0] ** c.num_scales),
                          weight_vocals, weight_inst)


# preset stem layouts (the reference's htdemucs 6-stem, drum-sep, karaoke
# background-vocal and woodwinds splits)
MULTISTEM_6 = ("vocals", "drums", "bass", "guitar", "piano", "other")
DRUM_KIT = ("kick", "snare", "toms", "hh", "cymbals", "other")
KARAOKE = ("lead_vocals", "back_vocals")
WOODWINDS = ("woodwinds", "other")


def vr_split(model, band_params, stems: tuple[str, str], window_size: int = 512,
             aggressiveness: float = 0.0, device: str | torch.device = "cuda"):
    """A VR net as a named two-stem split: ``stems`` = (primary, complement),
    e.g. KARAOKE or WOODWINDS, ordered by the model's primary stem.  The
    split maps (2, n) audio to {primary: (2, n), complement: (2, n)}."""
    sep = VRSeparator(model, band_params=band_params, primary=stems[0],
                      window_size=window_size, aggressiveness=aggressiveness, device=device)

    def split(audio, as_numpy: bool = True) -> dict:
        out = sep(audio, as_numpy=as_numpy)
        return {stems[0]: out[stems[0]], stems[1]: out["complement"]}

    return split


def vr_transform(model, band_params, keep: str = "primary", window_size: int = 512,
                 aggressiveness: float = 0.0, device: str | torch.device = "cuda"):
    """A VR net as an audio -> audio transform of the per-stem chain (a
    denoise or de-echo model keeps its primary stem); mono input is run as
    two equal channels and returned mono."""
    sep = VRSeparator(model, band_params=band_params, primary="primary",
                      window_size=window_size, aggressiveness=aggressiveness, device=device)

    def transform(audio, sr: int = 44100) -> np.ndarray:
        x = np.asarray(audio, np.float32)
        mono = x.ndim == 1
        if mono:
            x = np.stack([x, x])
        out = sep(x)["primary" if keep == "primary" else "complement"][..., : x.shape[-1]]
        return out[0] if mono else out

    return transform


# ---------------------------------------------------------------- transforms

def _spectrum(audio, n_fft: int, device):
    x = torch.as_tensor(np.asarray(audio, np.float32)).to(resolve_device(device))
    real, imag = stft(x, n_fft=n_fft, hop=n_fft // 4)
    return x, real, imag, torch.sqrt(real * real + imag * imag + 1e-12)


def _resynth(x, real, imag, gain, n_fft: int) -> np.ndarray:
    y = istft(real * gain, imag * gain, n_fft=n_fft, hop=n_fft // 4, length=x.shape[-1])
    return y.float().cpu().numpy()


def _percentile(x: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """numpy's linear-interpolation percentile along ``dim``, kept."""
    s = x.sort(dim=dim).values
    pos = (x.shape[dim] - 1) * q / 100.0
    lo, frac = int(np.floor(pos)), pos - np.floor(pos)
    hi = min(lo + 1, x.shape[dim] - 1)
    a, b = s.narrow(dim, lo, 1), s.narrow(dim, hi, 1)
    return a + (b - a) * frac


def spectral_gate_denoise(audio, sr: int, reduction_db: float = 12.0, n_fft: int = 2048,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """Per-bin noise floor (the 10th percentile over frames) and a soft
    spectral gate at twice it, floored at -``reduction_db`` dB."""
    x, real, imag, mag = _spectrum(audio, n_fft, device)
    thresh = 2.0 * _percentile(mag, 10.0, dim=-2)
    gain_min = 10.0 ** (-reduction_db / 20.0)
    gain = torch.clamp((mag - thresh) / (mag + 1e-9), gain_min, 1.0)
    return _resynth(x, real, imag, gain, n_fft)


def dereverb(audio, sr: int, strength: float = 0.5,
             device: str | torch.device = "cuda") -> np.ndarray:
    """Late-tail suppression: each bin's tail is the running maximum of the
    earlier frames' magnitudes decayed by 0.85 a frame, and the gain
    1 - strength * tail / magnitude, clipped to [0.1, 1]."""
    n_fft, decay = 2048, 0.85
    x, real, imag, mag = _spectrum(audio, n_fft, device)
    frames = mag.unbind(dim=-2)
    carry = torch.zeros_like(frames[0])
    tails = []
    for m in frames:
        tails.append(carry * decay)
        carry = torch.maximum(carry * decay, m)
    tail = torch.stack(tails, dim=-2)
    gain = torch.clamp(1.0 - strength * tail / (mag + 1e-9), 0.1, 1.0)
    return _resynth(x, real, imag, gain, n_fft)


def should_apply_transform(stem_name: str, setting: str) -> bool:
    """Policy dropdown semantics: Nothing / Main Vocals / All Vocals / All,
    keyed on the stem's name."""
    if setting == "All":
        return True
    low = stem_name.lower()
    if setting == "All Vocals":
        return "vocals" in low
    if setting == "Main Vocals":
        return "vocals" in low and "bg_vocals" not in low
    return False


def apply_policy_transforms(stems: dict, sr: int, policies: dict,
                            transforms: dict | None = None,
                            device: str | torch.device = "cuda") -> dict:
    """The per-stem transform chain under its policy dropdowns, in the order
    reverb -> echo -> crowd -> noise.  ``transforms`` maps those kinds to
    audio -> audio callables (e.g. :func:`vr_transform`); the defaults are
    the DSP transforms here."""
    fallbacks: dict[str, Callable] = {
        "reverb": lambda x, s: dereverb(x, s, strength=0.5, device=device),
        "echo": lambda x, s: dereverb(x, s, strength=0.3, device=device),
        "crowd": lambda x, s: spectral_gate_denoise(x, s, reduction_db=8.0, device=device),
        "noise": lambda x, s: spectral_gate_denoise(x, s, reduction_db=12.0, device=device),
    }
    transforms = {**fallbacks, **(transforms or {})}
    out = {}
    for stem, audio in stems.items():
        x = audio
        for kind in ("reverb", "echo", "crowd", "noise"):
            if should_apply_transform(stem, policies.get(kind, "Nothing")):
                x = transforms[kind](x, sr)
        out[stem] = np.asarray(x, np.float32)
    return out


def _median_filter(v: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Odd-length running median along ``dim`` with edge padding."""
    v = v.movedim(dim, -1)
    h = k // 2
    p = torch.cat([v[..., :1].expand(*v.shape[:-1], h), v,
                   v[..., -1:].expand(*v.shape[:-1], h)], dim=-1)
    return p.unfold(-1, k, 1).median(dim=-1).values.movedim(-1, dim)


def hpss_split(audio, sr: int, n_fft: int = 2048, kernel: int = 17,
               device: str | torch.device = "cuda") -> dict:
    """Median-filter harmonic/percussive split: a soft percussive mask from
    the magnitude smoothed over time (harmonic) and over frequency
    (percussive); "drums" is the masked resynthesis, "other" the rest."""
    x, real, imag, mag = _spectrum(audio, n_fft, device)
    harm = _median_filter(mag, kernel, dim=-2)
    perc = _median_filter(mag, kernel, dim=-1)
    mask_p = perc ** 2 / (harm ** 2 + perc ** 2 + 1e-12)
    drums = _resynth(x, real, imag, mask_p, n_fft)
    return {"drums": drums, "other": np.asarray(audio, np.float32) - drums}


STEM_TRANSFORM_POLICY = {
    # which transforms apply to which stems
    "vocals": ["dereverb", "denoise"],
    "instrumental": [],
    "drums": ["denoise"],
    "bass": [],
}


def apply_transform_chain(stems: dict, sr: int, enabled: list[str] | None = None,
                          device: str | torch.device = "cuda") -> dict:
    """Each stem through the transforms STEM_TRANSFORM_POLICY names for it,
    among ``enabled`` (default: dereverb and denoise)."""
    enabled = enabled if enabled is not None else ["dereverb", "denoise"]
    out = {}
    for stem, audio in stems.items():
        x = audio
        for t in STEM_TRANSFORM_POLICY.get(stem, []):
            if t not in enabled:
                continue
            if t == "dereverb":
                x = dereverb(x, sr, device=device)
            elif t == "denoise":
                x = spectral_gate_denoise(x, sr, device=device)
        out[stem] = x
    return out
