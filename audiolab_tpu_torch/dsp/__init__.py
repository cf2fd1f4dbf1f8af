"""DSP of the port (counterpart of audiolab_tpu/dsp/, with the same
exports)."""

from audiolab_tpu_torch.dsp.stereo import stereo_to_ms, ms_to_stereo, resample_side
from audiolab_tpu_torch.dsp.silence import restore_silence
from audiolab_tpu_torch.dsp.loudness import integrated_loudness, normalize_loudness
from audiolab_tpu_torch.dsp.pitch import (
    pitch_shift_granular,
    time_stretch,
    pitch_shift,
    hz_to_note,
    note_to_hz,
    autotune_f0,
)
from audiolab_tpu_torch.dsp.f0 import f0_autocorr
from audiolab_tpu_torch.dsp.autotune import auto_tune_track, detect_key
from audiolab_tpu_torch.dsp.reverb import (
    extract_reverb_params,
    apply_reverb,
    generate_ir,
    wiener_deconvolution,
    estimate_rt60,
)
from audiolab_tpu_torch.dsp.harmony import recreate_harmonies

__all__ = [
    "stereo_to_ms",
    "ms_to_stereo",
    "resample_side",
    "restore_silence",
    "integrated_loudness",
    "normalize_loudness",
    "pitch_shift_granular",
    "time_stretch",
    "pitch_shift",
    "hz_to_note",
    "note_to_hz",
    "autotune_f0",
    "f0_autocorr",
    "auto_tune_track",
    "detect_key",
    "extract_reverb_params",
    "apply_reverb",
    "generate_ir",
    "wiener_deconvolution",
    "estimate_rt60",
    "recreate_harmonies",
]
