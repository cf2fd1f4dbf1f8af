"""Declarative processor framework (counterpart of
audiolab_tpu/pipelines/base.py; reference: wrappers/base_wrapper.py).

Keeps the design the survey flagged as worth keeping (§5 config): one
``TypedInput`` schema per field drives kwarg validation, JSON-schema/OpenAPI
generation for the REST layer, and (if a UI is attached) widget layout — all
from a single declaration.

Differences from the reference: processors are plain instances registered in
a module-level registry (the singleton-__new__ dance of base_wrapper.py:101
is replaced by explicit registration); the ffmpeg video extract/recombine
helpers live in core.video.  ``process_audio`` takes the device its DSP runs
on as an argument (``run_chain`` resolves it); models injected through a
processor's ``configure`` keep their own.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable

import torch

from audiolab_tpu_torch.core.project import ProjectFiles

logger = logging.getLogger(__name__)

ProgressFn = Callable[[int, str, int], None]


def null_progress(step: int, message: str, total: int) -> None:  # noqa: ARG001
    pass


@dataclass
class TypedInput:
    """One declarative option field (base_wrapper.py:26-98)."""

    default: Any = None
    description: str = ""
    ge: float | None = None
    le: float | None = None
    step: float | None = None
    choices: list | None = None
    type: type = str
    gradio_type: str = "text"  # kept for UI-layer parity
    required: bool = False
    group_name: str | None = None

    def validate(self, name: str, value: Any) -> Any:
        if value is None:
            if self.required:
                raise ValueError(f"missing required option {name}")
            return self.default
        if self.type in (int, float):
            value = self.type(value)
            if self.ge is not None and value < self.ge:
                raise ValueError(f"{name}={value} below minimum {self.ge}")
            if self.le is not None and value > self.le:
                raise ValueError(f"{name}={value} above maximum {self.le}")
        elif self.type is bool:
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            value = bool(value)
        if self.choices and value not in self.choices:
            raise ValueError(f"{name}={value!r} not in {self.choices}")
        return value

    def json_schema(self) -> dict:
        js: dict[str, Any] = {"description": self.description}
        js["type"] = {int: "integer", float: "number", bool: "boolean", str: "string"}.get(
            self.type, "string"
        )
        if self.default is not None:
            js["default"] = self.default
        if self.ge is not None:
            js["minimum"] = self.ge
        if self.le is not None:
            js["maximum"] = self.le
        if self.choices:
            js["enum"] = list(self.choices)
        return js


class BaseProcessor:
    """Chainable processor: subclass, set title/priority/allowed_kwargs and
    implement process_audio (base_wrapper.py:101-135)."""

    title: str = "Base"
    priority: int = 100
    description: str = ""
    default_enabled: bool = False
    allowed_kwargs: dict[str, TypedInput] = {}

    def validate_kwargs(self, kwargs: dict) -> dict:
        out = {}
        for name, spec in self.allowed_kwargs.items():
            out[name] = spec.validate(name, kwargs.get(name))
        unknown = set(kwargs) - set(self.allowed_kwargs)
        if unknown:
            logger.debug("%s: ignoring unknown options %s", self.title, sorted(unknown))
        return out

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kwargs
    ) -> list[ProjectFiles]:
        raise NotImplementedError

    def json_schema(self) -> dict:
        """OpenAPI-style schema for the REST layer (base_wrapper.py:341-425)."""
        return {
            "title": self.title,
            "description": self.description,
            "properties": {k: v.json_schema() for k, v in self.allowed_kwargs.items()},
        }


_REGISTRY: dict[str, BaseProcessor] = {}


def register_processor(proc: BaseProcessor) -> BaseProcessor:
    _REGISTRY[proc.title] = proc
    return proc


def get_processor(title: str) -> BaseProcessor:
    if title not in _REGISTRY:
        _load_builtin_processors()
    return _REGISTRY[title]


def all_processors() -> list[BaseProcessor]:
    _load_builtin_processors()
    return sorted(_REGISTRY.values(), key=lambda p: p.priority)


def _load_builtin_processors() -> None:
    """Import the built-in processor modules (reflection over wrappers/ in
    the reference, layouts/process.py:36-76)."""
    import importlib

    for mod in (
        "audiolab_tpu_torch.pipelines.processors.separate",
        "audiolab_tpu_torch.pipelines.processors.clone",
        "audiolab_tpu_torch.pipelines.processors.merge",
        "audiolab_tpu_torch.pipelines.processors.remaster",
        "audiolab_tpu_torch.pipelines.processors.super_res",
        "audiolab_tpu_torch.pipelines.processors.convert",
        "audiolab_tpu_torch.pipelines.processors.export",
        "audiolab_tpu_torch.pipelines.processors.compare",
    ):
        try:
            importlib.import_module(mod)
        except ImportError as e:  # pragma: no cover
            logger.warning("processor module %s failed to import: %s", mod, e)


AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg", ".m4a", ".aac", ".opus")


def audio_inputs(files: list[str]) -> list[str]:
    """Filter chain inputs to audio files — each wrapper consumes only its
    input types (base_wrapper.py:745-821 filter conventions), so a DAW
    zip from Export or a PNG from Compare passes through untouched."""
    return [f for f in files if f.lower().endswith(AUDIO_EXTS)]
