"""Deployable model export (counterpart of audiolab_tpu/utils/export.py;
reference: modules/rvc/infer/lib/infer_pack/models_onnx.py's ONNX export
and infer/lib/jit/'s TorchScript export).

``torch.export`` is the counterpart of ``jax.export``: a function or module
traced on example inputs is saved as an ``ExportedProgram`` file that
reloads and runs without the Python model code.  Shapes are static, as the
JAX package's exported shapes are: the program takes inputs of the
example's shapes, dtypes and device.
"""

from __future__ import annotations

import torch
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn_or_module, example_args, path: str) -> str:
    """Trace ``fn_or_module(*example_args)`` with ``torch.export`` (no
    gradient) and save the program to ``path``; a plain function's
    tensors are captured as constants.  Returns ``path``."""
    module = fn_or_module if isinstance(fn_or_module, nn.Module) else _Fn(fn_or_module)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, path)
    return path


def load_program(path: str):
    """Reload a saved program; returns a callable of the example's
    arguments."""
    return torch.export.load(path).module()


class _RVCInfer(nn.Module):
    """``SynthesizerTrn.infer`` without a generator (no noise), as the JAX
    export passes ``None``."""

    def __init__(self, synth: nn.Module):
        super().__init__()
        self.synth = synth

    def forward(self, phone, lengths, pitch, pitchf, sid):
        return self.synth.infer(phone, lengths, pitch, pitchf, sid, None)


def export_rvc_synthesizer(state_dict_or_model, cfg, path: str, frames: int = 100,
                           batch: int = 1, device: str | torch.device = "cuda") -> str:
    """Export the RVC inference graph (the models_onnx.py equivalent) for
    ``batch`` x ``frames`` inputs on ``device`` (default the card; raises
    without one): phone (b, t, feat) fp32, lengths (b,) int64, pitch
    (b, t) int64, pitchf (b, t) fp32, sid (b,) int64 -> audio (b, t * upp).
    ``state_dict_or_model``: a ``SynthesizerTrn`` or its state_dict for
    ``cfg``."""
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn

    dev = resolve_device(device)
    if isinstance(state_dict_or_model, nn.Module):
        model = state_dict_or_model
    else:
        model = SynthesizerTrn(cfg)
        model.load_state_dict(state_dict_or_model, strict=True)
    model = model.to(dev).eval()
    args = (
        torch.zeros((batch, frames, cfg.feat_channels), dtype=torch.float32, device=dev),
        torch.full((batch,), frames, dtype=torch.long, device=dev),
        torch.ones((batch, frames), dtype=torch.long, device=dev),
        torch.full((batch, frames), 220.0, dtype=torch.float32, device=dev),
        torch.zeros((batch,), dtype=torch.long, device=dev),
    )
    return export_program(_RVCInfer(model), args, path)
