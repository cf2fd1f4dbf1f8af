"""Separate processor (counterpart of
audiolab_tpu/pipelines/processors/separate.py; reference: wrappers/separate.py).

Reference behaviors reproduced: SHA-256 + config cache check (:293-315,
400-412), TTS/generated-input skip heuristic handled by the chain layer,
stem naming conventions "(Vocals)"/"(Instrumental)" used downstream by Clone.

The model ensemble is injected via ``configure`` — with no checkpoints
loaded the processor falls back to a DSP vocal/instrumental split (center-
channel + harmonic masking) on the processor's device, so the chain stays
runnable end-to-end.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.dsp.reverb import extract_reverb_params
from audiolab_tpu_torch.kernels.stft import istft, stft
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    null_progress,
    register_processor,
)
from audiolab_tpu_torch.pipelines.separate import (
    StemSeparator,
    apply_policy_transforms,
    dereverb,
    hpss_split,
)


def dsp_vocal_split(audio: np.ndarray, sr: int,
                    device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """Checkpoint-free fallback: center-channel extraction + spectral mask.

    Vocals are mostly center-panned and harmonic; the mid-minus-side
    estimate gated by a per-bin voicedness mask gives a usable split for
    pipeline plumbing (not SDR-competitive with the neural ensemble)."""
    dev = resolve_device(device)
    if audio.ndim == 1:
        audio = np.stack([audio, audio])
    mid = 0.5 * (audio[0] + audio[1])
    side = 0.5 * (audio[0] - audio[1])

    n_fft, hop = 2048, 512
    rm, im = stft(torch.from_numpy(np.asarray(mid, np.float32)).to(dev), n_fft=n_fft, hop=hop)
    rs, is_ = stft(torch.from_numpy(np.asarray(side, np.float32)).to(dev), n_fft=n_fft, hop=hop)
    mag_m = torch.sqrt(rm**2 + im**2 + 1e-12)
    mag_s = torch.sqrt(rs**2 + is_**2 + 1e-12)
    # center dominance mask, soft
    mask = torch.clamp((mag_m - mag_s) / (mag_m + 1e-9), 0.0, 1.0) ** 2
    # vocals live mostly in 100 Hz - 12 kHz
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    band = ((freqs > 100) & (freqs < 12000)).astype(np.float32)
    mask = mask * torch.from_numpy(band).to(dev)[None, :]
    v = istft(rm * mask, im * mask, n_fft=n_fft, hop=hop, length=mid.shape[-1]).cpu().numpy()
    vocals = np.stack([v, v])
    inst = audio - vocals
    return {"vocals": vocals.astype(np.float32), "instrumental": inst.astype(np.float32)}


def dsp_bg_vocal_split(vocals: np.ndarray) -> dict[str, np.ndarray]:
    """Checkpoint-free lead/background vocal split: leads are
    center-panned, backs carry the stereo width (the reference uses the
    UVR-BVE karaoke checkpoint here, stem_separator.py:737-752 — wire
    ``vr_split(..., KARAOKE)`` when its weights are available)."""
    mid = 0.5 * (vocals[0] + vocals[1])
    side = 0.5 * (vocals[0] - vocals[1])
    lead = np.stack([mid, mid]).astype(np.float32)
    back = np.stack([side, -side]).astype(np.float32)
    return {"vocals": lead, "bg_vocals": back}


class Separate(BaseProcessor):
    title = "Separate"
    priority = 1
    description = "Split a track into vocal and instrumental stems."
    default_enabled = True
    # full reference option set (wrappers/separate.py:33-140)
    allowed_kwargs = {
        "vocals_only": TypedInput(
            default=True, description=(
                "Enable to separate only the main vocals and instrumental,"
                " disable for additional stems."), type=bool),
        "separate_bg_vocals": TypedInput(
            default=False,
            description="Separate background vocals from main vocals.",
            type=bool),
        "bg_vocal_layers": TypedInput(
            default=1, ge=1, le=10,
            description="Number of background vocal layers to separate.",
            type=int),
        "separate_drums": TypedInput(
            default=False, description="Separate the drum track.",
            type=bool),
        "separate_woodwinds": TypedInput(
            default=False,
            description="Separate the woodwind instruments.", type=bool),
        "alt_bass_model": TypedInput(
            default=False, description="Use an alternative bass model.",
            type=bool),
        "store_reverb_ir": TypedInput(
            default=False, description=(
                "Store the impulse response for reverb removal. Will be"
                " used to re-apply reverb later."), type=bool),
        "reverb_removal": TypedInput(
            default="Nothing", description="Apply reverb removal.",
            type=str,
            choices=["Nothing", "Main Vocals", "All Vocals", "All"]),
        "echo_removal": TypedInput(
            default="Nothing", description="Apply echo/delay removal.",
            type=str,
            choices=["Nothing", "Main Vocals", "All Vocals", "All"]),
        "crowd_removal": TypedInput(
            default="Nothing", description="Apply crowd noise removal.",
            type=str,
            choices=["Nothing", "Main Vocals", "All Vocals", "All"]),
        "noise_removal": TypedInput(
            default="Nothing", description="Apply general noise removal.",
            type=str,
            choices=["Nothing", "Main Vocals", "All Vocals", "All"]),
        "noise_removal_model": TypedInput(
            default="UVR-DeNoise.pth",
            description="Choose the model used for noise removal.",
            type=str,
            choices=["UVR-DeNoise.pth", "UVR-DeNoise-Lite.pth"]),
        "delay_removal_model": TypedInput(
            default="dereverb-echo_mel_band_roformer_sdr_13.4843_v2.ckpt",
            description="Select the model for echo/delay removal.",
            type=str,
            choices=[
                "dereverb-echo_mel_band_roformer_sdr_13.4843_v2.ckpt",
                "dereverb-echo_mel_band_roformer_sdr_10.0169.ckpt",
                "UVR-DeEcho-DeReverb.pth"]),
        "crowd_removal_model": TypedInput(
            default="UVR-MDX-NET_Crowd_HQ_1.onnx",
            description="Select the model for crowd noise removal.",
            type=str,
            choices=["UVR-MDX-NET_Crowd_HQ_1.onnx",
                     "mel_band_roformer_crowd_aufr33_viperx_sdr_8.7144.ckpt"]),
        "delete_extra_stems": TypedInput(
            default=True, description=(
                "Delete intermediate stem files after the chain"
                " completes."), type=bool),
        "use_cache": TypedInput(
            default=True,
            description="Reuse cached stems when config+hash match",
            type=bool),
    }

    separator: StemSeparator | None = None  # injected neural ensemble
    multistem = None        # callable audio -> {6 stems} (htdemucs_member)
    drum_splitter = None    # callable audio -> kit stems (mdx23c DrumSep)
    woodwind_splitter = None  # callable audio -> {woodwinds, other} (VR)
    bg_splitter = None      # callable vocals -> {vocals, bg_vocals} (BVE)
    alt_bass = None         # callable audio -> {bass, ...} (alt bass model,
    #                         stem_separator.py:505 _alt_bass_separation)
    transforms: dict | None = None  # {"reverb"/"echo"/"crowd"/"noise": fn}

    @classmethod
    def configure(cls, separator: StemSeparator, multistem=None,
                  drum_splitter=None, woodwind_splitter=None,
                  bg_splitter=None, alt_bass=None, transforms=None) -> None:
        cls.separator = separator
        cls.multistem = multistem
        cls.drum_splitter = drum_splitter
        cls.woodwind_splitter = woodwind_splitter
        cls.bg_splitter = bg_splitter
        cls.alt_bass = alt_bass
        cls.transforms = transforms

    def _cache_key(self, path: str, cfg: dict) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for blk in iter(lambda: f.read(1 << 20), b""):
                h.update(blk)
        h.update(json.dumps(cfg, sort_keys=True).encode())
        return h.hexdigest()[:16]

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        settings = {k: kw.get(k, ti.default)
                    for k, ti in self.allowed_kwargs.items()}
        use_cache = settings.pop("use_cache")
        policies = {
            "reverb": settings["reverb_removal"],
            "echo": settings["echo_removal"],
            "crowd": settings["crowd_removal"],
            "noise": settings["noise_removal"],
        }
        for proj in inputs:
            stage = proj.stage_dir("stems")
            src = proj.last_outputs[0]
            key = self._cache_key(src, settings)
            cache_meta = os.path.join(stage, "cache.json")
            base = os.path.splitext(os.path.basename(src))[0]

            if use_cache and os.path.exists(cache_meta):
                with open(cache_meta) as f:
                    meta = json.load(f)
                if meta.get("key") == key and all(
                        os.path.exists(p) for p in meta.get("files", [])):
                    proj.add_output("stems", meta["files"])
                    continue

            a = read_audio(src)
            audio = (a.samples if a.channels == 2
                     else np.vstack([a.samples, a.samples]))
            if self.separator is not None:
                stems = self.separator.separate(audio, callback=callback)
            else:
                callback(0, "Separating (DSP fallback)", 1)
                stems = dsp_vocal_split(audio, a.sample_rate, device=device)

            if settings["store_reverb_ir"]:
                # dry estimate = dereverbed vocals; IR recovered from the
                # wet/dry pair (wrappers/separate.py store_reverb_ir +
                # handlers/reverb.py:112)
                wet = stems["vocals"]
                dry = dereverb(wet, a.sample_rate, strength=0.7, device=device)
                params = extract_reverb_params(dry, wet, a.sample_rate, device=device)
                with open(os.path.join(proj.project_dir,
                                       "reverb_params.json"), "w") as f:
                    json.dump({k: (v.tolist() if hasattr(v, "tolist")
                                   else v) for k, v in params.items()}, f)

            if settings["separate_bg_vocals"]:
                split = self.bg_splitter or dsp_bg_vocal_split
                for layer in range(int(settings["bg_vocal_layers"])):
                    parts = split(stems["vocals"])
                    stems["vocals"] = parts["vocals"]
                    name = ("bg_vocals" if layer == 0
                            else f"bg_vocals_{layer + 1}")
                    stems[name] = parts.get("bg_vocals",
                                            parts.get("complement"))

            if not settings["vocals_only"] and self.multistem is not None:
                extra = self.multistem(audio)
                for nm, arr in extra.items():
                    if nm not in ("vocals", "instrumental"):
                        stems[nm] = np.asarray(arr, np.float32)
                if settings["alt_bass_model"] and self.alt_bass is not None:
                    alt = self.alt_bass(audio)
                    if "bass" in alt:
                        stems["bass"] = np.asarray(alt["bass"], np.float32)
            if settings["separate_drums"]:
                src_stem = stems.get("drums", stems["instrumental"])
                kit = (self.drum_splitter or
                       (lambda x: hpss_split(x, a.sample_rate, device=device)))(src_stem)
                for nm, arr in kit.items():
                    stems[f"drums_{nm}" if nm != "drums" else nm] = (
                        np.asarray(arr, np.float32))
            if settings["separate_woodwinds"] and self.woodwind_splitter:
                ww = self.woodwind_splitter(stems["instrumental"])
                if "woodwinds" in ww:
                    stems["woodwinds"] = np.asarray(ww["woodwinds"],
                                                    np.float32)

            # per-transform model selection: the transforms registry may
            # key converted checkpoints by their published file name
            # (stem_separator.py:795-800 transformations list)
            tr = dict(self.transforms or {})
            for kind, model_key in (("noise", settings["noise_removal_model"]),
                                    ("echo", settings["delay_removal_model"]),
                                    ("crowd", settings["crowd_removal_model"])):
                if model_key in tr:
                    tr[kind] = tr[model_key]
            stems = apply_policy_transforms(stems, a.sample_rate, policies,
                                            tr, device=device)

            label = {"vocals": "Vocals", "instrumental": "Instrumental",
                     "bg_vocals": "BG_Vocals"}
            files = []
            keep = (["vocals", "instrumental"]
                    if settings["delete_extra_stems"]
                    and settings["vocals_only"]
                    and not settings["separate_bg_vocals"]
                    and not settings["separate_drums"]
                    and not settings["separate_woodwinds"]
                    else list(stems))
            for nm in keep:
                p = os.path.join(
                    stage, f"{base} ({label.get(nm, nm.title())}).wav")
                write_audio(p, stems[nm], a.sample_rate)
                files.append(p)
            with open(cache_meta, "w") as f:
                json.dump({"key": key, "files": files}, f)
            proj.add_output("stems", files)
        return inputs


register_processor(Separate())
