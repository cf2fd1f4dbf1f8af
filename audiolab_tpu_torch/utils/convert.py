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
- The Separate -> Clone chain's formats: ``load_roformer_checkpoint``
  (BS- and mel-band RoFormer ``.ckpt``), ``load_rvc_checkpoint`` (the
  process_ckpt ``.pth``), ``load_hubert_state`` (fairseq HuBERT names, the
  trainer's non-strict path, as the JAX trainer's), ``load_rmvpe_checkpoint``, ``load_crepe_checkpoint``,
  ``load_htdemucs_checkpoint``, ``load_mdx23c_checkpoint`` and
  ``load_vr_checkpoint``.  Each gives the module the JAX package's loader
  gives: where that loader folds a layout (weight norm, RMVPE's GRU and
  VR's LSTM biases, VR's batch norms) the port folds it by the same numpy
  expression and stores it as ``utils/weights.py`` stores the JAX tree.
- Super Resolution, transcription, diarization and alignment:
  ``load_audiosr_scale_factor`` and ``load_audiosr_{vocoder,vae,unet}_checkpoint``
  (one whole AudioSR checkpoint holds all four), ``load_whisper_state`` (a
  state_dict, as ``convert_whisper`` takes it), ``load_wav2vec2_checkpoint``
  (HF ``Wav2Vec2ForCTC`` -> ``CTCWordAligner``), ``load_pyannet_checkpoint``
  (-> the state_dict ``NeuralDiarizer(pyannet_params=)`` takes),
  ``load_wespeaker_checkpoint`` and ``load_rtla_crnn_checkpoint``, folding
  weight norm, LSTM biases and batch norms (an affine-free one included)
  as the JAX converters do.
- The speech engines' formats: ``load_dac_checkpoint`` (descript-audio-codec's
  ``weights.pth``, decode path), ``load_dia_checkpoint`` (nari-labs Dia),
  and XTTS-v2's ``load_xtts_{gpt,conditioner,perceiver,hifigan,speaker}_checkpoint``
  (one whole ``model.pth`` holds all five) and ``load_xtts_dvae_checkpoint``
  (``dvae.pth``).
- The rest of the speech and cloning engines: Zonos's ``load_zonos_state``
  and ``load_zonos_prefix_state`` (one ``model.safetensors`` holds both)
  with ``zonos_prefix_specs_from_config``, OpenVoice's
  ``load_openvoice_checkpoint``, and Chatterbox's ``load_chatterbox_t3_state``,
  ``load_voice_encoder_state``, ``load_s3gen_state``, ``load_campplus_state``
  and ``load_s3tokenizer_state`` (one ``s3gen.safetensors`` holds the last
  three), which ``load_chatterbox_pipeline`` assembles from the published
  directory.  A ``load_*_state`` loads a state_dict into the module it is
  given, in place on its device, as ``load_whisper_state`` does.

Every loader of a file builds its module on ``device`` (default the card;
raises without one) and, ``load_hubert_state`` and ``load_zonos_state``
aside, loads strictly: a missing key or a wrong shape raises and
names the key.  The checkpoint's other tensors are dropped, as the JAX
loaders read only the keys their templates map.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
import re
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


def fold_state_dict(sd: dict, dim: int = 0) -> dict:
    """``sd`` with each weight-norm pair (``.weight_g`` / ``.weight_v``, or
    torch 2's ``.parametrizations.weight.original0`` / ``original1``)
    folded into a plain ``.weight`` over ``dim``."""
    out = {}
    pairs = (("weight_g", "weight_v"),
             ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    for k, v in sd.items():
        name = "." + k
        for g_sfx, v_sfx in pairs:
            if name.endswith("." + g_sfx):
                prefix = k[: -len(g_sfx)]
                out[prefix + "weight"] = fold_weight_norm(v, sd[prefix + v_sfx], dim=dim)
                break
            if name.endswith("." + v_sfx):
                break
        else:
            out[k] = v
    return out


def _load_strict(model: torch.nn.Module, sd: dict, what: str) -> torch.nn.Module:
    """``model.load_state_dict(strict=True)`` with the keys the module has;
    the checkpoint's others (the parts a decode path does not use) are
    dropped.  A batch norm's ``num_batches_tracked``, which no loader of the
    JAX package reads (and checkpoints older than torch 0.4.1 lack), keeps
    the module's own count when the file has none."""
    own = model.state_dict()
    sd = dict(sd)
    for k in own:
        if k.endswith(".num_batches_tracked") and k not in sd:
            sd[k] = own[k]
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:8]}"
                       + (f" and {len(missing) - 8} more" if len(missing) > 8 else ""))
    dropped = len(set(sd) - set(own))
    if dropped:
        logger.debug("%s: %d checkpoint tensors not used", what, dropped)
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


# ------------------------------------------------------------ shared steps

def _floats(sd: dict) -> dict:
    """The checkpoint's tensors, the floating ones in fp32 (the JAX loaders
    read every tensor through ``.float()``: published fp16 weights become
    fp32 exactly); entries that are not tensors are dropped."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items() if torch.is_tensor(v)}


def _strip(sd: dict, prefixes: tuple[str, ...]) -> dict:
    """``sd`` with the first of ``prefixes`` that a key starts with removed."""
    out = {}
    for k, v in sd.items():
        for pre in prefixes:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


_RECURRENT_BIAS = re.compile(r"^(.*)\.bias_hh_(l\d+(?:_reverse)?)$")


def _fold_recurrent_biases(sd: dict, lstm: bool) -> None:
    """Fold each recurrent layer's hidden-side bias into its input-side one
    in place, as the JAX converter does (its cells keep one bias a gate):
    an LSTM's four gate blocks, a GRU's r and z (its n keeps the hidden
    bias, which sits inside r * (...)) become ``b_ih + b_hh`` in fp32 and
    their ``b_hh`` 0."""
    for k in [k for k in sd if _RECURRENT_BIAS.match(k)]:
        base, sfx = _RECURRENT_BIAS.match(k).groups()
        bi, bh = sd[f"{base}.bias_ih_{sfx}"].clone(), sd[k].clone()
        n = bi.shape[0] if lstm else 2 * bi.shape[0] // 3
        bi[:n] += bh[:n]
        bh[:n] = 0.0
        sd[f"{base}.bias_ih_{sfx}"], sd[k] = bi, bh


def _fold_batch_norms(sd: dict) -> None:
    """Every batch norm of ``sd`` folded for inference in place, by the JAX
    converter's float64 expression (``extract`` "bnfold_w" / "bnfold_b":
    scale w / sqrt(var + 1e-5), bias b - mean * w / sqrt(var + 1e-5)), and
    stored as ``utils/weights.py`` stores a folded norm (mean 0, variance
    1 - eps, so the eval-mode norm multiplies by the scale).  A norm without
    affine (no ``.weight``) folds by "bnfoldna_w" / "bnfoldna_b" (scale
    1 / sqrt(var + 1e-5), bias -mean / sqrt(var + 1e-5)), rounded to fp32
    as the JAX tree holds it, and is stored as the statistics that fold to
    that (``weights._affine_free_bn``)."""
    from audiolab_tpu_torch.utils.weights import _affine_free_bn, _folded_bn

    for key in [k[: -len(".running_var")] for k in sd if k.endswith(".running_var")]:
        rm, rv = (sd[f"{key}.{n}"].double().numpy() for n in ("running_mean", "running_var"))
        if f"{key}.weight" not in sd:
            _affine_free_bn(sd, key, {"scale": (1.0 / np.sqrt(rv + 1e-5)).astype(np.float32),
                                      "bias": (-rm / np.sqrt(rv + 1e-5)).astype(np.float32)})
            continue
        w, b = (sd[f"{key}.{n}"].double().numpy() for n in ("weight", "bias"))
        _folded_bn(sd, key, {"scale": w / np.sqrt(rv + 1e-5),
                             "bias": b - rm * w / np.sqrt(rv + 1e-5)})


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
    stripped = _strip(sd, ("codec_model.", "model."))
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


# ------------------------------------------------------------ BS-RoFormer

def load_roformer_checkpoint(path: str, cfg, device: str | torch.device = "cuda"):
    """A published BS-RoFormer or mel-band RoFormer ``.ckpt`` (lucidrains
    names; ZFTurbo's files nest them under ``state_dict`` or ``state``, a
    Lightning file prefixes ``model.``) -> ``models/separation/roformer.
    BSRoformer`` of ``cfg`` on ``device``.  ``cfg``'s dims, bands and stems
    (in order: ``mask_estimators.{i}`` is ``cfg.stems[i]``; a residual stem
    has no estimator) must be the checkpoint yaml's."""
    from audiolab_tpu_torch.models.separation.roformer import BSRoformer

    dev = resolve_device(device)
    ckpt = torch_load_weights(path)
    sd = _strip(_floats(ckpt.get("state_dict", ckpt.get("state", ckpt))), ("model.",))
    with dev:
        model = BSRoformer(cfg)
    return _load_strict(model, sd, "RoFormer checkpoint").eval()


# ------------------------------------------------------------------- RVC

_RVC_SR_TAGS = {"32k": 32000, "40k": 40000, "48k": 48000}


def load_rvc_checkpoint(path: str, device: str | torch.device = "cuda"):
    """A voice's ``.pth`` as upstream's process_ckpt writes it (``{"weight",
    "config", "sr", "f0", "version"}``, fp16 tensors, weight-norm pairs) ->
    (``models/rvc/synthesizer.SynthesizerTrn`` on ``device``, its config).
    As in the JAX loader, the config is ``config_for`` of the ``sr`` tag
    (an unknown tag reads as 48 kHz) and ``version`` (default v2), the
    tensors are made fp32, the pairs folded over dim 0, and the training
    posterior ``enc_q.*`` is dropped.  A file marked ``f0: 0`` (upstream's
    pitchless ``*_nono`` synthesizer, whose decoder has no harmonic source)
    is refused: neither package has that synthesizer."""
    from audiolab_tpu_torch.models.rvc import synthesizer as S

    dev = resolve_device(device)
    cpt = torch_load_weights(path)
    if not int(cpt.get("f0", 1)):
        raise ValueError(f"{path}: f0 0 is a voice without pitch (upstream's *_nono "
                         "synthesizer); only the NSF synthesizer is supported")
    sr = _RVC_SR_TAGS.get(str(cpt.get("sr", "48k")), 48000)
    cfg = S.config_for(sr, cpt.get("version", "v2"))
    with dev:
        model = S.SynthesizerTrn(cfg)
    sd = fold_state_dict(_floats(cpt["weight"]))
    return _load_strict(model, sd, "RVC checkpoint").eval(), cfg


# ---------------------------------------------------------------- HuBERT

def load_hubert_state(model: torch.nn.Module, state_dict: dict):
    """A fairseq HuBERT state_dict (``hubert_base.pt``'s ``model`` entry, or a
    flat ``.npz`` of the same names) into the port's ``Hubert`` /
    ``HubertFeatureExtractor`` as the trainer loads it, the counterpart of the
    JAX trainer's ``convert_hubert(..., strict=False)``: tensors in fp32,
    ``encoder.pos_conv.0``'s weight-norm pair folded over dim 2 (fairseq's
    ``weight_g`` is (1, 1, k)), the keys the file has loaded and the module's
    own values kept for the others; a wrong shape raises."""
    sd = fold_state_dict(_floats(state_dict), dim=2)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)
    return model


# ----------------------------------------------------------------- RMVPE

def load_rmvpe_checkpoint(path: str, device: str | torch.device = "cuda"):
    """The published ``rmvpe.pt`` (a state_dict) -> a full-size
    ``models/rmvpe.RMVPE`` (the bf16 U-Net, the reference's half-precision
    mode) on ``device``: batch norms with their statistics, the GRU's r and z
    hidden biases folded into the input ones."""
    from audiolab_tpu_torch.models import rmvpe as R

    dev = resolve_device(device)
    sd = _floats(torch_load_weights(path))
    _fold_recurrent_biases(sd, lstm=False)
    with dev:
        model = R.RMVPE()
    return _load_strict(model, sd, "RMVPE checkpoint").eval()


# ----------------------------------------------------------------- CREPE

def load_crepe_checkpoint(path: str, model: str = "full", device: str | torch.device = "cuda"):
    """torchcrepe's ``full.pth`` / ``tiny.pth`` -> ``models/crepe.Crepe(model)``
    on ``device``, batch norms with their statistics."""
    from audiolab_tpu_torch.models.crepe import Crepe

    dev = resolve_device(device)
    with dev:
        net = Crepe(model)
    return _load_strict(net, _floats(torch_load_weights(path)), "CREPE checkpoint").eval()


# --------------------------------------------------------------- HTDemucs

def load_htdemucs_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """A demucs v4 state_dict (``models.0.`` / ``model.`` / ``state.``
    prefixes stripped; attention's packed ``in_proj_weight``, or the same as
    ``in_proj.weight``) -> ``models/separation/htdemucs.HTDemucs`` of ``cfg``
    (default ``HTDemucsConfig()``, htdemucs_6s) on ``device``.  demucs's own
    packages (``klass``, ``args``, ``state``) need a full unpickle: re-save
    their ``state`` as a plain state_dict."""
    from audiolab_tpu_torch.models.separation.htdemucs import HTDemucs, HTDemucsConfig

    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)), ("models.0.", "model.", "state."))
    for k in list(sd):
        for sfx in ("weight", "bias"):
            if k.endswith(f".in_proj.{sfx}"):
                sd.setdefault(k[: -len(f".in_proj.{sfx}")] + f".in_proj_{sfx}", sd[k])
    with dev:
        model = HTDemucs(cfg or HTDemucsConfig())
    return _load_strict(model, sd, "HTDemucs checkpoint").eval()


# ---------------------------------------------------- MDX23C (TFC-TDF v3)

_MDX23C_SCALE = re.compile(r"^((?:encoder_blocks\.\d+\.downscale)|(?:decoder_blocks\.\d+\.upscale))"
                           r"\.conv\.")


def load_mdx23c_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """An MDX23C ``.ckpt`` (ZFTurbo's tfc_tdf_v3 names; ``model.`` /
    ``module.`` / ``state_dict.`` prefixes stripped, the down/upscale
    Sequential under ``.conv`` or not) -> ``models/separation/mdx23c.
    TFCTDFNetV3`` on ``device``.  ``cfg``: an ``MDX23CConfig`` or a dict of
    its fields (the checkpoint yaml's audio and model sections; default
    InstVoc_HQ)."""
    from audiolab_tpu_torch.models.separation.mdx23c import MDX23CConfig, TFCTDFNetV3

    dev = resolve_device(device)
    cfg = MDX23CConfig(**cfg) if isinstance(cfg, dict) else (cfg or MDX23CConfig())
    sd = _strip(_floats(torch_load_weights(path)), ("model.", "module.", "state_dict."))
    sd = {_MDX23C_SCALE.sub(r"\1.", k): v for k, v in sd.items()}
    with dev:
        model = TFCTDFNetV3(cfg)
    return _load_strict(model, sd, "MDX23C checkpoint").eval()


# -------------------------------------------- UVR VR architecture (.pth)

def load_vr_checkpoint(path: str, cfg=None, n_fft: int | None = None,
                       device: str | torch.device = "cuda"):
    """A UVR VR-arch ``.pth`` (tsurumeso lib_v5 names; ``model.`` /
    ``module.`` stripped) -> ``models/separation/vr`` net on ``device``.  The
    arch and widths are sniffed from the file's own keys (``infer_vr_config``,
    before the prefixes go, as the JAX loader sniffs: a prefixed file needs
    ``cfg``) unless ``cfg`` is given; ``n_fft`` (2 x the band params' combined
    bins) is needed for the old arch.  As the JAX loader does, every batch norm is
    folded for inference and each LSTM's biases summed; the training-only
    auxiliary heads, which the JAX nets do not carry, are 0."""
    from audiolab_tpu_torch.models.separation.vr import infer_vr_config, make_vr_net

    dev = resolve_device(device)
    sd = _floats(torch_load_weights(path))
    cfg = cfg or infer_vr_config(sd, n_fft=n_fft)
    sd = _strip(sd, ("model.", "module."))
    with dev:
        model = make_vr_net(cfg)
    _fold_batch_norms(sd)
    _fold_recurrent_biases(sd, lstm=True)
    for k, v in model.state_dict().items():
        if k.split(".")[0] in ("aux_out", "aux1_out", "aux2_out"):
            sd[k] = torch.zeros_like(v, device="cpu")
    return _load_strict(model, sd, "VR checkpoint").eval()


# ---------------------------------------------------------------- AudioSR

def load_audiosr_scale_factor(path: str, default: float = 1.0) -> float:
    """The latent ``scale_factor`` buffer of an AudioSR checkpoint (audiosr
    ddpm.py:672; set by scale_by_std at :747), under ``scale_factor``,
    ``model.scale_factor`` or ``state_dict.scale_factor``, read through fp32
    as the JAX loader reads it; ``default`` where the file has none.
    ``AudioSRCheckpointPipeline(scale_factor=)`` takes it."""
    sd = torch_load_weights(path)
    for k in ("scale_factor", "model.scale_factor", "state_dict.scale_factor"):
        if k in sd:
            return float(torch.as_tensor(sd[k]).float().reshape(()))
    return float(default)


def load_audiosr_vocoder_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """An AudioSR checkpoint's 48 kHz vocoder (``first_stage_model.vocoder.``
    / ``vocoder.`` / ``generator.`` stripped; every convolution a
    weight-norm pair, ``ups.*`` transposed, folded over dim 0) ->
    ``models/audiosr_vocoder.AudioSRVocoder(**kw)`` on ``device``."""
    from audiolab_tpu_torch.models.audiosr_vocoder import AudioSRVocoder

    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)),
                ("first_stage_model.vocoder.", "vocoder.", "generator."))
    with dev:
        model = AudioSRVocoder(**kw)
    return _load_strict(model, fold_state_dict(sd), "AudioSR vocoder checkpoint").eval()


def load_audiosr_vae_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """An AudioSR checkpoint's VAE (``first_stage_model.`` stripped) ->
    ``models/audiosr_vae.AudioSRVAE(**kw)`` on ``device``.  A whole AudioSR
    checkpoint's vocoder and UNet tensors are dropped."""
    from audiolab_tpu_torch.models.audiosr_vae import AudioSRVAE

    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)), ("first_stage_model.",))
    with dev:
        model = AudioSRVAE(**kw)
    return _load_strict(model, sd, "AudioSR VAE checkpoint").eval()


def load_audiosr_unet_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """An AudioSR checkpoint's UNet (``model.diffusion_model.`` stripped;
    the names of the ``unet_layer_schedule`` the module walks) ->
    ``models/audiosr_unet.AudioSRUNet(cfg)`` (default the basic
    configuration) on ``device``."""
    from audiolab_tpu_torch.models.audiosr_unet import AudioSRUNet, AudioSRUNetConfig

    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)), ("model.diffusion_model.",))
    with dev:
        model = AudioSRUNet(cfg or AudioSRUNetConfig())
    return _load_strict(model, sd, "AudioSR UNet checkpoint").eval()


# ---------------------------------------------------------------- Whisper

def load_whisper_state(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """An openai-whisper state_dict (``model_state_dict`` of its ``.pt``; the
    port's names, fp16 tensors made fp32) into ``models/whisper.
    WhisperModel``, the counterpart of ``convert_whisper``.  The encoder's
    sinusoidal positions and the alignment heads, which the module computes
    or does not use, are dropped."""
    return _load_strict(model, _floats(state_dict), "Whisper state_dict")


# ---------------------------------------------------------------- wav2vec2

# HF Wav2Vec2ForCTC's names -> the port's (fairseq's, under ``encoder.``):
# the inverse of ``weights._W2V_HF``
_HF_W2V = (
    (r"^wav2vec2\.feature_extractor\.conv_layers\.0\.layer_norm\.",
     "encoder.feature_extractor.conv_layers.0.2."),
    (r"^wav2vec2\.feature_extractor\.conv_layers\.(\d+)\.conv\.",
     r"encoder.feature_extractor.conv_layers.\1.0."),
    (r"^wav2vec2\.feature_projection\.layer_norm\.", "encoder.layer_norm."),
    (r"^wav2vec2\.feature_projection\.projection\.", "encoder.post_extract_proj."),
    (r"^wav2vec2\.encoder\.pos_conv_embed\.conv\.", "encoder.encoder.pos_conv.0."),
    (r"^wav2vec2\.encoder\.layer_norm\.", "encoder.encoder.layer_norm."),
    (r"^wav2vec2\.encoder\.layers\.(\d+)\.attention\.(\w+)\.",
     r"encoder.encoder.layers.\1.self_attn.\2."),
    (r"^wav2vec2\.encoder\.layers\.(\d+)\.layer_norm\.",
     r"encoder.encoder.layers.\1.self_attn_layer_norm."),
    (r"^wav2vec2\.encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.",
     r"encoder.encoder.layers.\1.fc1."),
    (r"^wav2vec2\.encoder\.layers\.(\d+)\.feed_forward\.output_dense\.",
     r"encoder.encoder.layers.\1.fc2."),
    (r"^wav2vec2\.encoder\.layers\.(\d+)\.final_layer_norm\.",
     r"encoder.encoder.layers.\1.final_layer_norm."),
)


def load_wav2vec2_checkpoint(path: str, cfg=None, vocab: dict | None = None,
                             device: str | torch.device = "cuda"):
    """An HF ``Wav2Vec2ForCTC`` checkpoint (``wav2vec2.*`` and ``lm_head``) ->
    ``models/wav2vec2.CTCWordAligner`` of ``cfg`` (default
    ``Wav2Vec2Config()``, wav2vec2-base-960h) with ``vocab`` on ``device``.
    The positional convolution's weight-norm pair (``weight_g`` /
    ``weight_v``, or torch 2's ``parametrizations.weight.original0/1``) is
    folded over dim 2."""
    from audiolab_tpu_torch.models.wav2vec2 import CTCWordAligner, Wav2Vec2Config, Wav2Vec2CTC

    dev = resolve_device(device)
    sd = {}
    for k, v in _floats(torch_load_weights(path)).items():
        for pat, rep in _HF_W2V:
            k2 = re.sub(pat, rep, k)
            if k2 != k:
                k = k2
                break
        sd[k] = v
    with dev:
        model = Wav2Vec2CTC(cfg or Wav2Vec2Config())
    model = _load_strict(model, fold_state_dict(sd, dim=2), "wav2vec2 checkpoint")
    return CTCWordAligner(model, vocab, device=dev)


# ---------------------------------------------------------------- PyanNet

def load_pyannet_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda") -> dict:
    """A pyannote segmentation-3.0 state_dict (Lightning's ``model.``
    stripped) -> the state_dict of ``models/pyannet.PyanNet(cfg)`` (default
    ``PyanNetConfig()``) loaded on ``device``, which
    ``NeuralDiarizer(pyannet_params=)`` takes.  The sinc filterbank's
    ``low_hz_`` / ``band_hz_`` pass through; each LSTM direction's hidden
    bias is folded into its input bias, as the JAX converter folds it."""
    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig

    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)), ("model.",))
    _fold_recurrent_biases(sd, lstm=True)
    with dev:
        model = PyanNet(cfg or PyanNetConfig())
    return _load_strict(model, sd, "PyanNet checkpoint").eval().state_dict()


# ----------------------------------------------------------------- RTLA

def load_rtla_crnn_checkpoint(path: str, config_json: str | None = None,
                              device: str | torch.device = "cuda"):
    """RTLA's pretrained model -> ``models/rtla.RtlaCRNN`` on ``device``
    (``align_take``'s ``phoneme_model``).  A ``.pt`` / ``.pth`` is a dict of
    ``model_state_dict`` and ``config``; a ``.safetensors`` comes with its
    sibling JSON (``config_json``, hyperparameters under ``config``).  What
    the config lacks comes from the file's shapes: ``num_lbl`` from
    ``model.2.bias``, the complexity from ``model.2.weight``'s columns / 16
    (``n_mels`` defaults to 66).  The three batch norms and the LSTM's
    hidden bias are folded as the JAX converter folds them."""
    from audiolab_tpu_torch.models.rtla import RtlaCRNN, RtlaCRNNConfig

    dev = resolve_device(device)
    if path.endswith((".pt", ".pth")):
        blob = torch_load_weights(path)
        sd, meta = blob.get("model_state_dict", blob), {"config": blob.get("config", {})}
    else:
        sd, meta = torch_load_weights(path), {}
        if config_json:
            with open(config_json) as f:
                meta = json.load(f)
    sd = _floats(sd)
    mc = dict(meta.get("config", {}))
    cfg = RtlaCRNNConfig(
        n_mels=int(mc.get("n_mels", 66)),
        num_lbl=int(mc.get("num_lbl", sd["model.2.bias"].shape[0])),
        model_complexity=int(mc.get("model_complexity", sd["model.2.weight"].shape[1] // 16)))
    _fold_batch_norms(sd)
    _fold_recurrent_biases(sd, lstm=True)
    with dev:
        model = RtlaCRNN(cfg)
    return _load_strict(model, sd, "RTLA CRNN checkpoint").eval()


# ------------------------------------------------------------- WeSpeaker

def load_wespeaker_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """wespeaker-voxceleb-resnet34-LM's ``pytorch_model.bin`` (``resnet.`` /
    ``model.`` / ``speaker_encoder.`` stripped, the margin head
    ``projection.*`` dropped) -> ``models/wespeaker.WeSpeakerResNet`` on
    ``device`` (``NeuralDiarizer(wespeaker=)``).  Without ``cfg``,
    ``two_emb_layer`` is sniffed from a ``seg_2.weight`` in the file.  Every
    batch norm is folded as the JAX converter folds it, ``seg_bn_1`` (no
    affine) included."""
    from audiolab_tpu_torch.models.wespeaker import WeSpeakerConfig, WeSpeakerResNet

    dev = resolve_device(device)
    raw = _floats(torch_load_weights(path))
    cfg = cfg or WeSpeakerConfig(two_emb_layer=any(k.endswith("seg_2.weight") for k in raw))
    sd = {k: v for k, v in _strip(raw, ("resnet.", "model.", "speaker_encoder.")).items()
          if not k.startswith("projection.")}
    _fold_batch_norms(sd)
    with dev:
        model = WeSpeakerResNet(cfg)
    return _load_strict(model, sd, "WeSpeaker checkpoint").eval()


# -------------------------------------------------------------------- DAC

def load_dac_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """descript-audio-codec's ``weights.pth`` (the tensors under
    ``state_dict``, or at the top level) -> (``models/codecs.DACDecoder`` of
    ``cfg`` on ``device``, ``cfg``); the default config is
    ``DACConfig(decoder_dim=1536)``, the 44.1 kHz model.  Every weight-norm
    pair (the convolutions, the transposed up-convolutions, each quantizer's
    1x1 ``out_proj``) is folded over dim 0; snake alphas load as (1, ch, 1).
    The encoder and the quantizers' ``in_proj``, which the decode path does
    not use, are dropped, as the JAX loader's decode-only mapping drops
    them."""
    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder

    dev = resolve_device(device)
    ckpt = torch_load_weights(path)
    sd = fold_state_dict(_floats(ckpt.get("state_dict", ckpt)))
    cfg = cfg or DACConfig(decoder_dim=1536)
    with dev:
        model = DACDecoder(cfg)
    return _load_strict(model, sd, "DAC checkpoint").eval(), cfg


# -------------------------------------------------------------------- Dia

def load_dia_checkpoint(path: str, cfg, device: str | torch.device = "cuda"):
    """nari-labs Dia's ``.pth`` or ``.safetensors`` -> ``models/dia.DiaModel``
    of ``cfg`` on ``device``.  The module keeps the file's names and
    DenseGeneral layouts (q/k/v (in, heads, hd), with ``kv_heads`` on the
    decoder's k and v; o (heads, hd, out); ``mlp.wi_fused`` (dim, 2, 4 dim);
    ``decoder.logits_dense`` (dim, n_q, V)) and its per-codebook
    ``decoder.embeddings.Q`` tables, which the JAX converter concatenates
    into one offset table.

    Both packages derive the encoder's head dim as ``dim_enc //
    n_heads_enc``, so the published Dia-1.6B encoder (16 heads x 128 over a
    1024 width) loads into neither: its q/k/v/o shapes are refused."""
    from audiolab_tpu_torch.models.dia import DiaModel

    dev = resolve_device(device)
    sd = _floats(torch_load_weights(path))
    with dev:
        model = DiaModel(cfg)
    return _load_strict(model, sd, "Dia checkpoint").eval()


# ---------------------------------------------------------------- XTTS-v2
#
# Each loader takes the file's top level as the state_dict, as the JAX
# loaders do: a file that nests the weights (Coqui's trainer saves them
# under ``model``) is refused for the keys it lacks.

def _xtts_part(path: str, prefixes: tuple[str, ...], make, device, what: str, fold=False):
    dev = resolve_device(device)
    sd = _strip(_floats(torch_load_weights(path)), prefixes)
    if fold:
        sd = fold_state_dict(sd)
    with dev:
        model = make()
    return _load_strict(model, sd, what).eval()


def load_xtts_gpt_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """XTTS-v2's ``model.pth`` -> ``models/xtts.XttsGPT2(**kw)`` (default the
    published 30 x 1024 x 16 heads) on ``device``: ``gpt.`` stripped once,
    so the inner GPT-2 is at ``gpt.h.N``; transformers' Conv1D weights are
    (in, out) as stored."""
    from audiolab_tpu_torch.models.xtts import XttsGPT2

    return _xtts_part(path, ("gpt.",), lambda: XttsGPT2(**kw), device,
                      "XTTS-v2 GPT checkpoint")


def load_xtts_conditioner_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """XTTS-v2's ``model.pth`` -> ``models/xtts.XttsConditioningEncoder(**kw)``
    on ``device`` (``gpt.conditioning_encoder.`` stripped)."""
    from audiolab_tpu_torch.models.xtts import XttsConditioningEncoder

    return _xtts_part(path, ("gpt.conditioning_encoder.", "conditioning_encoder."),
                      lambda: XttsConditioningEncoder(**kw), device,
                      "XTTS-v2 conditioning encoder checkpoint")


def load_xtts_perceiver_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """XTTS-v2's ``model.pth`` -> ``models/xtts.XttsPerceiverResampler(**kw)``
    on ``device`` (``gpt.conditioning_perceiver.`` stripped)."""
    from audiolab_tpu_torch.models.xtts import XttsPerceiverResampler

    return _xtts_part(path, ("gpt.conditioning_perceiver.", "conditioning_perceiver."),
                      lambda: XttsPerceiverResampler(**kw), device,
                      "XTTS-v2 perceiver checkpoint")


def load_xtts_hifigan_checkpoint(path: str, device: str | torch.device = "cuda"):
    """XTTS-v2's ``model.pth`` -> ``models/xtts.XttsHifiganDecoder()`` at the
    published geometry (1024-d latents, 512-d d-vector, 1024x upsampling) on
    ``device``: ``hifigan_decoder.waveform_decoder.`` stripped, the
    weight-norm pairs of the up-convolutions and the residual blocks
    (``weight_g`` / ``weight_v`` or torch 2's ``parametrizations``) folded
    over dim 0."""
    from audiolab_tpu_torch.models.xtts import XttsHifiganDecoder

    return _xtts_part(path, ("hifigan_decoder.waveform_decoder.", "waveform_decoder."),
                      XttsHifiganDecoder, device, "XTTS-v2 HiFi decoder checkpoint",
                      fold=True)


def load_xtts_speaker_checkpoint(path: str, device: str | torch.device = "cuda"):
    """XTTS-v2's ``model.pth`` -> ``models/xtts.XttsSpeakerEncoder()`` at the
    published geometry (H/ASP ResNet34-SE into 512) on ``device``
    (``hifigan_decoder.speaker_encoder.`` stripped).  The batch norms keep
    their running statistics, as the JAX loader's ``batch_stats`` do; the
    mel front end's buffers are dropped."""
    from audiolab_tpu_torch.models.xtts import XttsSpeakerEncoder

    return _xtts_part(path, ("hifigan_decoder.speaker_encoder.", "speaker_encoder."),
                      XttsSpeakerEncoder, device, "XTTS-v2 speaker encoder checkpoint")


def load_xtts_dvae_checkpoint(path: str, device: str | torch.device = "cuda", **kw):
    """XTTS-v2's ``dvae.pth`` (or the ``dvae.`` part of a file) ->
    ``models/xtts.XttsDVAE(**kw)`` on ``device``; ``codebook.embed`` (an EMA
    buffer upstream) is the codebook, its other EMA buffers are dropped."""
    from audiolab_tpu_torch.models.xtts import XttsDVAE

    return _xtts_part(path, ("dvae.",), lambda: XttsDVAE(**kw), device,
                      "XTTS-v2 DVAE checkpoint")


# ------------------------------------------------------------------ Zonos

# the names convert_zonos maps: the backbone (with ``backbone.norm_f``), the
# per-codebook embeddings and heads
_ZONOS_MAPPED = ("backbone.", "embeddings.", "heads.")


def load_zonos_state(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """Zyphra Zonos's state_dict (``model.safetensors``, the hybrid's names)
    into ``models/zonos.ZonosModel``, the counterpart of ``convert_zonos``:
    the backbone, ``embeddings.q``, ``heads.q`` and ``backbone.norm_f``, in
    place.  Each of them must be in the file: a missing one raises with its
    key, and so does a wrong shape (which the JAX converter's non-strict
    fill passes through: ROADMAP queue 3).  The branches the JAX converter
    leaves unmapped (``text_emb``, ``spk_proj``, ``emotion``, ``rate``,
    ``pitch``) keep the module's values.  A Mamba1 layer raises, as in the
    JAX converter: upstream hybrid checkpoints need ``ZonosConfig(mixer=
    "mamba2")``."""
    from audiolab_tpu_torch.models.zonos import MambaBlock

    for i, layer in enumerate(model.backbone.layers):
        if isinstance(layer.mixer, MambaBlock):
            raise ValueError(f"layer {i} is a Mamba1-style block; upstream hybrid "
                             "checkpoints need ZonosConfig(mixer='mamba2')")
    sd = {k: v for k, v in model.state_dict().items() if not k.startswith(_ZONOS_MAPPED)}
    sd.update((k, v) for k, v in _floats(state_dict).items() if k.startswith(_ZONOS_MAPPED))
    return _load_strict(model, sd, "Zonos state_dict")


def load_zonos_prefix_state(bank: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """The checkpoint's prefix conditioner (``model.prefix_conditioner.`` or
    ``prefix_conditioner.`` stripped) into ``models/zonos.
    ZonosPrefixConditioner`` in place, the counterpart of
    ``convert_zonos_prefix``: the bank's specs and projection are the
    module's (``zonos_prefix_specs_from_config`` reads them from
    ``config.json``); its own ``project`` and ``norm`` are the names left
    after the prefix, as the JAX mapping's stripped leading dot gives them."""
    sd = _strip(_floats(state_dict), ("model.prefix_conditioner.", "prefix_conditioner."))
    return _load_strict(bank, sd, "Zonos prefix conditioner state_dict")


def zonos_prefix_specs_from_config(conditioners: list) -> tuple:
    """``config.json``'s ``prefix_conditioner.conditioners`` list -> the
    ``models/zonos.CondSpec`` tuple ``ZonosPrefixConditioner`` takes, with
    the JAX package's defaults."""
    from audiolab_tpu_torch.models.zonos import CondSpec

    return tuple(
        CondSpec(type=d["type"], name=d["name"], cond_dim=d.get("cond_dim"),
                 projection=d.get("projection", "none"),
                 uncond_type=d.get("uncond_type", "none"),
                 input_dim=d.get("input_dim", 1),
                 min_val=float(d.get("min_val", 0.0)),
                 max_val=float(d.get("max_val", 1.0)))
        for d in conditioners)


# --------------------------------------------------------------- OpenVoice

def load_openvoice_checkpoint(path: str, cfg=None, device: str | torch.device = "cuda"):
    """OpenVoice's ``converter.pth`` (the tensors under ``model``, or at the
    top level; ``model.`` stripped) -> ``models/openvoice.ToneColorConverter``
    of ``cfg`` (default ``ToneColorConfig()``) on ``device``.  Every
    weight-norm pair is folded over dim 0 (the reference encoder's six
    Conv2d, the WaveNet layers, HiFiGAN's residual convolutions and
    ``conv_post``, and the transposed up-convolutions over their input
    channels); the reference GRU's r and z hidden biases are folded into
    its input ones, as the JAX converter folds them."""
    from audiolab_tpu_torch.models.openvoice import ToneColorConfig, ToneColorConverter

    dev = resolve_device(device)
    ckpt = torch_load_weights(path)
    sd = fold_state_dict(_strip(_floats(ckpt.get("model", ckpt)), ("model.",)))
    _fold_recurrent_biases(sd, lstm=False)
    with dev:
        model = ToneColorConverter(cfg or ToneColorConfig())
    return _load_strict(model, sd, "OpenVoice converter checkpoint").eval()


# -------------------------------------------------------------- Chatterbox

def load_chatterbox_t3_state(t3: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """``t3_cfg.safetensors`` into ``models/chatterbox_t3.T3`` in place, the
    counterpart of ``convert_chatterbox_t3``: the module keeps the file's
    names (its ``tfmr`` hooks map ``tfmr.layers.N`` onto the LLaMA stack)."""
    return _load_strict(t3, _floats(state_dict), "Chatterbox T3 state_dict")


def load_voice_encoder_state(ve: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """``ve.safetensors`` (the LSTM in torch's layout, ``proj``) into
    ``models/chatterbox_t3.VoiceEncoder`` in place, the counterpart of
    ``convert_voice_encoder``."""
    return _load_strict(ve, _floats(state_dict), "voice encoder state_dict")


def load_s3gen_state(s3gen: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """``s3gen.safetensors``'s ``flow.*`` and ``mel2wav.*`` into
    ``models/chatterbox_s3gen.S3Token2Wav`` in place, the counterpart of
    ``convert_s3gen``: HiFT's weight-norm pairs (its convolutions, and its
    transposed up-convolutions over their input channels) folded over dim
    0; the bundled ``tokenizer.*`` and ``speaker_encoder.*`` dropped.  The
    flow's fixed noise ``rand_noise`` is a buffer, not a weight, and stays
    as the module made it."""
    sd = {k: v for k, v in _floats(state_dict).items() if k.startswith(("flow.", "mel2wav."))}
    return _load_strict(s3gen, fold_state_dict(sd), "S3Gen state_dict")


def _under(state_dict: dict, prefix: str) -> dict:
    """The entries of ``state_dict`` under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in _floats(state_dict).items() if k.startswith(prefix)}


def load_campplus_state(model: torch.nn.Module, state_dict: dict, prefix: str = ""):
    """3D-Speaker's CAMPPlus (``s3gen.safetensors`` bundles it under
    ``speaker_encoder.``: pass that as ``prefix``) into
    ``models/campplus.CAMPPlus`` in place, the counterpart of
    ``convert_campplus``: the batch norms keep their running statistics
    (the JAX BNInfer holds them unfolded), the affine-free
    ``xvector.dense.nonlinear.batchnorm`` included."""
    return _load_strict(model, _under(state_dict, prefix), "CAMPPlus state_dict")


# the FSQ projection's spellings, in the order the JAX converter tries them
_S3TOK_FSQ = ("quantizer.vq", "quantizer._codebook", "quantizer")


def load_s3tokenizer_state(model: torch.nn.Module, state_dict: dict, prefix: str = ""):
    """The s3tokenizer package's S3TokenizerV2 (``s3gen.safetensors``
    bundles it under ``tokenizer.``: pass that as ``prefix``) into
    ``models/s3tokenizer.S3TokenizerV2`` in place, the counterpart of
    ``convert_s3tokenizer``: the FSQ projection is read from the first of
    ``quantizer.vq``, ``quantizer._codebook`` and ``quantizer`` that holds
    a ``project_down``."""
    sd = _under(state_dict, prefix)
    fsq = next((c for c in _S3TOK_FSQ if f"{c}.project_down.weight" in sd), _S3TOK_FSQ[0])
    old = f"{fsq}.project_down."
    sd = {("quantizer.vq.project_down." + k[len(old):] if k.startswith(old) else k): v
          for k, v in sd.items()}
    return _load_strict(model, sd, "S3 tokenizer state_dict")


_S3TOK_BLOCK = re.compile(r"tokenizer\.encoder\.blocks\.(\d+)\.")


def _chatterbox_builtin(conds: dict, mel_dim: int) -> dict:
    """``conds.pt`` (the builtin voice: ``t3`` and ``gen`` dicts) flattened
    one level -> the engine's ``builtin`` dict (speaker_emb, prompt_tokens,
    ref_tokens, ref_mel, ref_xvector), each entry found under its nested or
    its bare name, as the JAX loader finds it."""
    flat: dict = {}
    for k, v in (conds.items() if isinstance(conds, dict) else []):
        if isinstance(v, dict):
            flat.update((f"{k}.{kk}", vv) for kk, vv in v.items())
        else:
            flat[k] = v

    def pick(*keys):
        for k in keys:
            if k in flat:
                v = flat[k]
                return np.asarray(v.float().numpy() if hasattr(v, "numpy") else v)
        return None

    builtin = {}
    rows = (("speaker_emb", ("t3.speaker_emb", "speaker_emb"), lambda a: a.reshape(-1)),
            ("prompt_tokens", ("t3.cond_prompt_speech_tokens", "cond_prompt_speech_tokens"),
             lambda a: a.reshape(1, -1).astype(np.int32)),
            ("ref_tokens", ("gen.prompt_token", "prompt_token"),
             lambda a: a.reshape(1, -1).astype(np.int32)),
            ("ref_mel", ("gen.prompt_feat", "prompt_feat"), lambda a: a.reshape(1, -1, mel_dim)),
            ("ref_xvector", ("gen.embedding", "embedding"), lambda a: a.reshape(-1)))
    for name, keys, shape in rows:
        v = pick(*keys)
        if v is not None:
            builtin[name] = shape(v)
    return builtin


def load_chatterbox_pipeline(checkpoint_dir: str, device: str | torch.device = "cuda"):
    """resemble-ai Chatterbox's published directory -> the port's
    ``pipelines/tts.ChatterboxCheckpointEngine`` on ``device``, the
    counterpart of the JAX ``load_chatterbox_pipeline``: T3 at
    ``T3CkptConfig()`` (``max_seq_len`` 4096) from ``t3_cfg.safetensors``,
    the voice encoder at its defaults from ``ve.safetensors``, and from
    ``s3gen.safetensors`` S3Gen at ``FlowConfig()`` / ``HiFTConfig()``,
    CAMPPlus at ``CAMPPlusConfig()`` when ``speaker_encoder.*`` is there,
    and the S3 tokenizer when ``tokenizer.encoder.*`` is there (its
    ``n_layer``, ``n_mels`` and ``n_state`` read from the file).  The
    optional ``tokenizer.json`` goes through ``ChatterboxTokenizer``, the
    optional ``conds.pt`` (read with ``weights_only=True``) gives the
    builtin voice.  A missing one of the three weight files raises
    ``FileNotFoundError`` naming it."""
    from audiolab_tpu_torch.models.campplus import CAMPPlus, CAMPPlusConfig
    from audiolab_tpu_torch.models.chatterbox_s3gen import FlowConfig, HiFTConfig, S3Token2Wav
    from audiolab_tpu_torch.models.chatterbox_t3 import T3, T3CkptConfig, VoiceEncoder
    from audiolab_tpu_torch.models.s3tokenizer import S3TokenizerConfig, S3TokenizerV2
    from audiolab_tpu_torch.pipelines.tts import ChatterboxCheckpointEngine, ChatterboxTokenizer

    dev = resolve_device(device)

    def path(name):
        p = os.path.join(checkpoint_dir, name)
        if not os.path.exists(p):
            raise FileNotFoundError(f"{name} not found in {checkpoint_dir}")
        return p

    t3_path, ve_path, s3gen_path = map(path, ("t3_cfg.safetensors", "ve.safetensors",
                                              "s3gen.safetensors"))
    with dev:
        t3 = T3(T3CkptConfig(), max_seq_len=4096)
    load_chatterbox_t3_state(t3, torch_load_weights(t3_path))
    with dev:
        ve = VoiceEncoder()
    load_voice_encoder_state(ve, torch_load_weights(ve_path))
    sd = torch_load_weights(s3gen_path)
    with dev:
        s3gen = S3Token2Wav(FlowConfig(), HiFTConfig())
    load_s3gen_state(s3gen, sd)
    campplus = s3tok = None
    if any(k.startswith("speaker_encoder.") for k in sd):
        with dev:
            campplus = CAMPPlus(CAMPPlusConfig())
        load_campplus_state(campplus, sd, prefix="speaker_encoder.")
    if any(k.startswith("tokenizer.encoder.") for k in sd):
        n_layer = 1 + max(int(m.group(1)) for k in sd if (m := _S3TOK_BLOCK.match(k)))
        n_state, n_mels = sd["tokenizer.encoder.conv1.weight"].shape[:2]
        with dev:
            s3tok = S3TokenizerV2(S3TokenizerConfig(n_mels=n_mels, n_state=n_state,
                                                    n_layer=n_layer))
        load_s3tokenizer_state(s3tok, sd, prefix="tokenizer.")
    del sd
    tok_path = os.path.join(checkpoint_dir, "tokenizer.json")
    tokenizer = ChatterboxTokenizer(tok_path).encode if os.path.exists(tok_path) else None
    conds_path = os.path.join(checkpoint_dir, "conds.pt")
    builtin = (_chatterbox_builtin(torch_load_weights(conds_path), s3gen.flow_cfg.mel_dim)
               if os.path.exists(conds_path) else {})
    return ChatterboxCheckpointEngine(t3, s3gen, ve=ve, tokenizer=tokenizer, builtin=builtin,
                                      campplus=campplus, s3tok=s3tok, device=dev)
