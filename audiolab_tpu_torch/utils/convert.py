"""Reading upstream checkpoints into the port's modules (counterpart of the
parts of audiolab_tpu/utils/convert.py that YuE's checkpoint path uses).

The port's modules carry the upstream checkpoints' parameter names, so a
loader here is a read, a weight-norm fold or a prefix strip where the
published layout differs, and ``load_state_dict(strict=True)``:

- ``read_safetensors``: the safetensors format read by hand (an 8-byte
  little-endian header length, the JSON header of dtypes, shapes and data
  offsets, then the raw bytes, BF16 included): the card's machine has no
  ``safetensors`` package.
- ``torch_load_weights``: ``.safetensors`` by that reader, ``.npz`` by
  numpy, everything else (``.pth``, ``.bin``, ``.ckpt``) by
  ``torch.load(weights_only=True)``, never a full unpickle.
- ``load_hf_dir_weights`` / ``lm_config_from_hf_dir``: an HF LLaMA
  directory (one file, or shards through ``model.safetensors.index.json``)
  and its ``config.json``.
- ``load_llama_checkpoint``, ``load_xcodec_checkpoint`` and
  ``load_yue_pipeline``: YuE's stage LMs, its xcodec decoder and the whole
  stack with the mm tokenizer.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
import struct

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device

logger = logging.getLogger(__name__)

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor} in the stored types."""
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size > base else None
        try:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dtype = _ST_DTYPES.get(info["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
                begin, end = info["data_offsets"]
                if end == begin:
                    out[name] = torch.empty(info["shape"], dtype=dtype)
                    continue
                raw = np.frombuffer(mm, np.uint8, count=end - begin, offset=base + begin).copy()
                out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
        finally:
            if mm is not None:
                mm.close()
    return out


def torch_load_weights(path: str) -> dict:
    """A checkpoint's tensors: ``.safetensors`` by :func:`read_safetensors`,
    ``.npz`` by numpy (as tensors), otherwise ``torch.load`` with
    ``weights_only=True`` (plain tensors and containers; a file that needs a
    full unpickle must be re-exported as a plain state_dict)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def fold_weight_norm(g, v, dim: int = 0) -> torch.Tensor:
    """g * v / ||v|| with the norm over every axis but ``dim`` (floored at
    1e-12), in fp32 by the JAX package's numpy expression."""
    g = np.asarray(torch.as_tensor(g).float().numpy())
    v = np.asarray(torch.as_tensor(v).float().numpy())
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def fold_state_dict(sd: dict) -> dict:
    """``sd`` with each weight-norm pair (``.weight_g`` / ``.weight_v``, or
    torch 2's ``.parametrizations.weight.original0`` / ``original1``)
    folded into a plain ``.weight`` over dim 0."""
    out = {}
    pairs = (("weight_g", "weight_v"),
             ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    for k, v in sd.items():
        name = "." + k
        for g_sfx, v_sfx in pairs:
            if name.endswith("." + g_sfx):
                prefix = k[: -len(g_sfx)]
                out[prefix + "weight"] = fold_weight_norm(v, sd[prefix + v_sfx], dim=0)
                break
            if name.endswith("." + v_sfx):
                break
        else:
            out[k] = v
    return out


def _load_strict(model: torch.nn.Module, sd: dict, what: str) -> torch.nn.Module:
    """``model.load_state_dict(strict=True)`` with the keys the module has;
    the checkpoint's others (the parts a decode path does not use) are
    dropped."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:8]}"
                       + (f" and {len(missing) - 8} more" if len(missing) > 8 else ""))
    dropped = len(set(sd) - set(own))
    if dropped:
        logger.debug("%s: %d checkpoint tensors not used", what, dropped)
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


# ------------------------------------------------------------------ LLaMA

def load_llama_state(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """An HF LLaMA state_dict into ``TransformerLM`` (the same names); the
    head is the embedding table where the file has no ``lm_head``."""
    sd = dict(sd)
    if ("lm_head.weight" not in sd and "model.embed_tokens.weight" in sd
            and "lm_head.weight" in model.state_dict()):
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return _load_strict(model, sd, "LLaMA checkpoint")


def load_llama_checkpoint(path: str, cfg, device: str | torch.device = "cuda"):
    """An HF LLaMA ``.safetensors`` / ``.bin`` -> ``models/lm.TransformerLM``
    of ``cfg`` on ``device`` (YuE's stages)."""
    from audiolab_tpu_torch.models.lm import TransformerLM

    dev = resolve_device(device)
    with dev:
        model = TransformerLM(cfg)
    return load_llama_state(model, torch_load_weights(path)).eval()


def load_hf_dir_weights(d: str) -> dict:
    """An HF checkpoint directory's tensors (one ``model.safetensors`` or
    ``pytorch_model.bin``, or the shards ``model.safetensors.index.json``
    names) in one state_dict."""
    idx = os.path.join(d, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            paths = sorted({os.path.join(d, v) for v in json.load(f)["weight_map"].values()})
    else:
        for name in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                paths = [p]
                break
        else:
            paths = sorted(glob.glob(os.path.join(d, "*.safetensors")))
            if not paths:
                raise FileNotFoundError(f"no weights in {d}")
    sd: dict = {}
    for p in paths:
        sd.update(torch_load_weights(p))
    return sd


def lm_config_from_hf_dir(d: str, **overrides):
    """A LLaMA-family ``config.json`` -> ``models/lm.LMConfig`` (the type is
    LMConfig's bf16 default unless ``dtype`` is overridden, as in the JAX
    package)."""
    from audiolab_tpu_torch.models.lm import LMConfig

    with open(os.path.join(d, "config.json")) as f:
        c = json.load(f)
    heads = c["num_attention_heads"]
    kw = dict(
        vocab_size=c["vocab_size"], dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=heads,
        n_kv_heads=c.get("num_key_value_heads", heads),
        ffn_dim=c["intermediate_size"],
        rope_theta=float(c.get("rope_theta", 10000.0)),
        norm_eps=float(c.get("rms_norm_eps", 1e-5)),
        max_seq_len=int(c.get("max_position_embeddings", 4096)),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
    )
    kw.update(overrides)
    return LMConfig(**kw)


# ------------------------------------------------------------------ xcodec

def load_xcodec_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """YuE's xcodec checkpoint -> ``models/codecs.XCodecDecoder`` on
    ``device``: the ``codec_model`` / ``state_dict`` nesting and the
    ``codec_model.`` / ``model.`` prefixes stripped, weight-norm pairs
    folded."""
    from audiolab_tpu_torch.models.codecs import XCodecConfig, XCodecDecoder

    dev = resolve_device(device)
    ckpt = torch_load_weights(path)
    sd = ckpt.get("codec_model", ckpt.get("state_dict", ckpt))
    stripped = {}
    for k, v in sd.items():
        for pre in ("codec_model.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        stripped[k] = v
    with dev:
        model = XCodecDecoder(cfg or XCodecConfig())
    return _load_strict(model, fold_state_dict(stripped), "xcodec checkpoint").eval()


# ------------------------------------------------------------------ YuE

def load_yue_pipeline(stage1_dir: str, stage2_dir: str, xcodec_path: str,
                      tokenizer_model: str | None = None, xcodec_cfg=None, vocab=None,
                      device: str | torch.device = "cuda"):
    """YuE's published stack on ``device``: the stage-1 and stage-2 HF LLaMA
    directories (with their ``config.json``), the xcodec checkpoint and the
    mm ``tokenizer.model`` (byte text without one).  Returns a
    ``models/yue.YuEPipeline`` on the xcodec decode path."""
    from audiolab_tpu_torch.models.codecs import XCodecConfig
    from audiolab_tpu_torch.models.lm import TransformerLM
    from audiolab_tpu_torch.models.mm_vocab import MMTokenizer
    from audiolab_tpu_torch.models.yue import YuEConfig, YuEPipeline, YuEVocab

    dev = resolve_device(device)

    def load_stage(d):
        cfg = lm_config_from_hf_dir(d)
        with dev:
            model = TransformerLM(cfg)
        return cfg, load_llama_state(model, load_hf_dir_weights(d))

    s1_cfg, s1 = load_stage(stage1_dir)
    s2_cfg, s2 = load_stage(stage2_dir)
    vocab = vocab or YuEVocab()
    if s1_cfg.vocab_size != vocab.size:
        logger.warning("stage-1 vocab %d != mm-v0.2 layout %d; codec id offsets may "
                       "not line up", s1_cfg.vocab_size, vocab.size)
    xcodec = load_xcodec_checkpoint(xcodec_path, xcodec_cfg or XCodecConfig(), device=dev)
    tok = MMTokenizer(model_file=tokenizer_model) if tokenizer_model else None
    cfg = YuEConfig(vocab=vocab, stage1=s1_cfg, stage2=s2_cfg)
    return YuEPipeline(cfg, s1, s2, xcodec=xcodec, tokenizer=tok, device=dev)
