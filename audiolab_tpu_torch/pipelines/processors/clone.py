"""Clone processor (counterpart of audiolab_tpu/pipelines/processors/clone.py;
reference: wrappers/clone.py) — voice conversion of "(Vocals)" stems via
RVC / OpenVoice / TTS.

Reference behaviors reproduced: the full option schema (:74-285), method
dispatch RVC|OpenVoice|TTS (:413-460), input filtering to vocal stems
(:73-120), stereo preservation via mid/side (clone mid only, :200-270),
diarization speaker pick (:395-410), volume_mix_rate -> rms_mix_rate and
accent_strength -> protect mapping (:324-325), pitch correction
(auto-tune) of the cloned vocal, silence restore after conversion
(pipeline.py:469-535).

Backends are injected via ``configure``: the RVC VoiceConverter, an
optional CloningFacade (pipelines/cloning.py: OpenVoice converter + TTS
engine + diarizer).  Without a facade the OpenVoice and TTS methods raise
and ``diarize_speakers`` is ignored, as in the JAX processor.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import AudioData, read_audio, write_audio
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.dsp.autotune import auto_tune_track
from audiolab_tpu_torch.dsp.silence import restore_silence
from audiolab_tpu_torch.dsp.stereo import ms_to_stereo, resample_side, stereo_to_ms
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    null_progress,
    register_processor,
)

_POLICY = ["Nothing", "Main Vocals", "All Vocals", "All"]
_F0_METHODS = ["hybrid", "pm", "harvest", "dio", "rmvpe", "rmvpe_onnx",
               "rmvpe+", "crepe", "crepe-tiny", "mangio-crepe",
               "mangio-crepe-tiny"]


class Clone(BaseProcessor):
    title = "Clone"
    priority = 2
    description = "Convert vocal stems to a target voice."
    default_enabled = True
    # full reference field set (wrappers/clone.py:74-285)
    allowed_kwargs = {
        "clone_method": TypedInput(
            default="RVC", description="The voice cloning method to use.",
            choices=["RVC", "OpenVoice", "TTS"], type=str),
        "selected_voice": TypedInput(
            default=None,
            description="The voice model to use for RVC cloning.",
            type=str, group_name="RVC Controls"),
        "pitch_shift": TypedInput(
            default=0, ge=-24, le=24, type=int,
            description=("Pitch shift in semitones (+12 for an octave up,"
                         " -12 for an octave down)."),
            group_name="RVC Controls"),
        "pitch_correction": TypedInput(
            default=False, type=bool,
            description=("Apply pitch correction (Auto-Tune) to the"
                         " cloned vocals."),
            group_name="RVC Controls"),
        "pitch_correction_humanize": TypedInput(
            default=0.95, ge=0.0, le=1.0, step=0.01, type=float,
            description=("How much to humanize the pitch correction."
                         " 0=robotic, 1=human-like."),
            group_name="RVC Controls"),
        "clone_stereo": TypedInput(
            default=False, type=bool,
            description="Preserve stereo information when cloning.",
            group_name="RVC Controls"),
        "source_speaker": TypedInput(
            default=None, type=str,
            description=("Reference audio file for voice cloning (for"
                         " OpenVoice and TTS)."),
            group_name="Source Speaker"),
        "voice_strength": TypedInput(
            default=0.5, ge=0.0, le=1.0, step=0.01, type=float,
            description=("Strength of voice characteristics to apply in"
                         " OpenVoice cloning."),
            group_name="OpenVoice Controls"),
        "custom_text": TypedInput(
            default="", type=str,
            description=("Optional custom text for TTS voice cloning. If"
                         " empty, text will be extracted from input"
                         " audio."),
            group_name="OpenVoice Controls"),
        "clone_bg_vocals": TypedInput(
            default=False, type=bool,
            description=("Clone background vocals in addition to the main"
                         " vocals."),
            group_name="Common Options"),
        "diarize_speakers": TypedInput(
            default=False, type=bool,
            description=("Detect and separate multiple speakers in the"
                         " audio before cloning."),
            group_name="Common Options"),
        "speaker_index": TypedInput(
            default=0, ge=0, type=int,
            description=("When diarization is enabled, which speaker to"
                         " clone (0 is the first speaker)."),
            group_name="Common Options"),
        "pitch_extraction_method": TypedInput(
            default="rmvpe+", choices=_F0_METHODS, type=str,
            description="Pitch extraction algorithm for RVC.",
            group_name="Advanced RVC Options"),
        "volume_mix_rate": TypedInput(
            default=0.9, ge=0.0, le=1.0, step=0.01, type=float,
            description=("Mix ratio for volume envelope. 1=original"
                         " input volume."),
            group_name="Advanced RVC Options"),
        "accent_strength": TypedInput(
            default=0.2, ge=0.0, le=1.0, step=0.01, type=float,
            description=("Strength of target voice characteristics"
                         " (higher can introduce artifacts)."),
            group_name="Advanced RVC Options"),
        "filter_radius": TypedInput(
            default=3, ge=0, le=7, step=1, type=int,
            description=("Median filter radius for 'harvest' pitch"
                         " recognition."),
            group_name="Advanced RVC Options"),
        "index_rate": TypedInput(
            default=1.0, ge=0.0, le=1.0, step=0.01, type=float,
            description=("Feature search proportion when using the vector"
                         " index. 0=disable, 1=full usage."),
            group_name="Advanced RVC Options"),
        "merge_type": TypedInput(
            default="median", choices=["median", "mean"], type=str,
            description="Merge strategy for hybrid pitch extraction.",
            group_name="Advanced RVC Options"),
        "crepe_hop_length": TypedInput(
            default=160, type=int,
            description="Hop length for CREPE-based pitch extraction.",
            group_name="Advanced RVC Options"),
        "f0_autotune": TypedInput(
            default=False, type=bool,
            description=("Automatically apply autotune to extracted pitch"
                         " values."),
            group_name="Advanced RVC Options"),
        "rmvpe_onnx": TypedInput(
            default=False, type=bool,
            description=("Use the ONNX version of the RMVPE model for"
                         " pitch extraction if available."),
            group_name="Advanced RVC Options"),
        # kept for API back-compat with earlier releases of this package
        "voice_model": TypedInput(
            default=None, description="Alias of selected_voice", type=str),
        "preserve_stereo": TypedInput(
            default=True, description="Alias of clone_stereo", type=bool),
        "protect": TypedInput(
            default=None, ge=0.0, le=0.5, type=float,
            description="Alias of accent_strength"),
    }

    converter = None  # injected RVC VoiceConverter
    facade = None     # injected CloningFacade (openvoice/tts/diarizer)

    @classmethod
    def configure(cls, converter, facade=None) -> None:
        cls.converter = converter
        cls.facade = facade

    def _select_inputs(self, files: list[str], clone_bg: bool) -> list[str]:
        """Vocal-stem filtering conventions (base_wrapper.py:745-821)."""
        vocals = [f for f in files if "(Vocals)" in f or "vocal" in os.path.basename(f).lower()]
        if not clone_bg:
            vocals = [f for f in vocals if "(BG" not in f and "back" not in os.path.basename(f).lower()]
        return vocals or files[:1]

    def _clone_rvc(self, a, kw, device):
        if self.converter is None:
            raise RuntimeError(
                "No voice model loaded. Load one with "
                "Clone.configure(VoiceConverter(...)).")
        vc = self.converter
        method = kw["pitch_extraction_method"]
        if kw["rmvpe_onnx"] and method == "rmvpe":
            method = "rmvpe_onnx"
        # a new config object: the converter's modules and index stay where
        # they are, shared by every request
        vc.cfg = replace(
            vc.cfg, f0_method=method, merge_type=kw["merge_type"],
            filter_radius=int(kw["filter_radius"]),
            crepe_hop=int(kw["crepe_hop_length"]),
            f0_autotune=bool(kw["f0_autotune"]))
        x = a.samples
        stereo = kw["clone_stereo"] or kw.get("preserve_stereo", True)
        if x.shape[0] == 2 and stereo:
            mid, side = stereo_to_ms(torch.from_numpy(x).to(device))
            mono = mid.cpu().numpy()
        else:
            mono = x.mean(axis=0)
            side = None
        mono16 = resample_poly_np(mono, a.sample_rate, 16000)
        protect = (kw["protect"] if kw.get("protect") is not None
                   else kw["accent_strength"])
        out = vc.convert(
            mono16, transpose=int(kw["pitch_shift"] or 0),
            index_rate=float(kw["index_rate"]), protect=float(protect),
            rms_mix_rate=float(kw["volume_mix_rate"]))
        out = restore_silence(mono, out, a.sample_rate, vc.synth_cfg.sr, device=device)
        if kw["pitch_correction"]:
            strength = 1.0 - float(kw["pitch_correction_humanize"])
            out, _key, _scale = auto_tune_track(
                out, a.sample_rate, strength=max(strength, 0.0), device=device)
        if side is not None:
            side_r = resample_side(side, out.shape[-1])
            return ms_to_stereo(torch.from_numpy(out).to(device), side_r).cpu().numpy()
        return out

    def _ref_audio(self, kw):
        src = kw.get("source_speaker")
        if not src or not os.path.exists(src):
            raise RuntimeError(
                "OpenVoice/TTS cloning needs source_speaker (a reference"
                " audio file path).")
        r = read_audio(src)
        return r.samples.mean(axis=0), r.sample_rate

    def _clone_openvoice(self, a, kw):
        if self.facade is None or self.facade.openvoice is None:
            raise RuntimeError("OpenVoice backend not loaded — pass a "
                               "CloningFacade to Clone.configure.")
        ref, ref_sr = self._ref_audio(kw)
        src = a.samples.mean(axis=0)
        # OpenVoiceCloner answers (waveform, its model rate): brought to the
        # input's rate before the blend (the JAX processor takes the tuple
        # for the waveform and fails)
        y, out_sr = self.facade.clone_voice_openvoice(src, a.sample_rate, ref, ref_sr)
        y = np.asarray(y, np.float32)
        if out_sr != a.sample_rate:
            y = resample_poly_np(y, out_sr, a.sample_rate)
        tau = float(kw["voice_strength"])
        n = min(len(y), len(src))
        return tau * y[:n] + (1.0 - tau) * np.asarray(src[:n], np.float32)

    def _clone_tts(self, a, kw):
        if self.facade is None or self.facade.tts is None:
            raise RuntimeError("TTS backend not loaded — pass a "
                               "CloningFacade to Clone.configure.")
        text = kw["custom_text"]
        if not text:
            transcriber = getattr(self.facade, "transcriber", None)
            if transcriber is None:
                raise RuntimeError(
                    "custom_text is empty and no transcriber is"
                    " configured to extract text from the input audio.")
            text = transcriber(a.samples.mean(axis=0), a.sample_rate)
        ref, ref_sr = self._ref_audio(kw)
        y, sr = self.facade.clone_voice_tts(text, ref, ref_sr)
        return np.asarray(y, np.float32), int(sr)

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        settings = {k: kw.get(k, ti.default)
                    for k, ti in self.allowed_kwargs.items()}
        if settings.get("voice_model") and not settings["selected_voice"]:
            settings["selected_voice"] = settings["voice_model"]
        method = settings["clone_method"]

        for proj in inputs:
            targets = self._select_inputs(proj.last_outputs,
                                          settings["clone_bg_vocals"])
            passthrough = [f for f in proj.last_outputs if f not in targets]
            outputs = []
            stage = proj.stage_dir("cloned")
            for i, f in enumerate(targets):
                callback(i, f"Cloning {os.path.basename(f)}", len(targets))
                a = read_audio(f)
                if settings["diarize_speakers"] and self.facade is not None:
                    picked, _turns = self.facade.choose_speaker(
                        a.samples.mean(axis=0), a.sample_rate,
                        index=int(settings["speaker_index"]))
                    a = AudioData(samples=np.asarray(picked, np.float32)[None],
                                  sample_rate=a.sample_rate)
                out_sr = a.sample_rate
                if method == "OpenVoice":
                    result = self._clone_openvoice(a, settings)
                elif method == "TTS":
                    result, out_sr = self._clone_tts(a, settings)
                else:
                    result = self._clone_rvc(a, settings, device)
                base = os.path.splitext(os.path.basename(f))[0]
                out_path = os.path.join(stage, f"{base} (Cloned).wav")
                write_audio(out_path, result, out_sr)
                outputs.append(out_path)
            proj.add_output("cloned", outputs + passthrough)
        return inputs


register_processor(Clone())
