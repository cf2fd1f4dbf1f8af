"""The port's checkpoint readers and YuE's loaders
(audiolab_tpu_torch/utils/convert.py) on the CPU, against the safetensors
package and the JAX package's loaders (audiolab_tpu/utils/convert.py) on
files the test writes in the upstream layouts:

- the port's safetensors reader (no ``safetensors`` import) against
  ``safetensors.numpy.load_file`` on fp32, fp16 and int64, and against
  ``safetensors.torch.load_file`` on bf16 (numpy has no bf16);
- an HF LLaMA directory sharded through ``model.safetensors.index.json``;
- tied embeddings (no ``lm_head`` in the file);
- ``fold_weight_norm`` and both weight-norm layouts;
- the xcodec checkpoint (nested under ``codec_model``, ``model.``
  prefixes, weight-norm pairs);
- ``load_yue_pipeline`` of both packages on the same stack: the same
  weights, the same tokenizer, identical stage-1 and stage-2 codes.

The LLaMA files hold bf16-representable values (the published checkpoints
are bf16; the JAX reader cannot read a bf16 safetensors file without
ml_dtypes' numpy type, so they are stored as fp32), so the port's bf16
modules hold exactly the JAX package's numbers.  The codes are compared
with both stacks computing in fp32: in bf16 the two frameworks round the
products in another order (tests/test_torch_port_lm.py), which would move
a Gumbel argmax at a near tie.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file

from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import lm as JL
from audiolab_tpu.models import yue as JY
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.models import lm as TL
from audiolab_tpu_torch.models import yue as TY
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import spm as TS
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

VOCAB = dict(codebook_size=32, text_size=64, pre_xcodec_codebooks=2, n_q_total=8,
             post_xcodec_ids=16)
XC = dict(n_q=2, codebook_size=16, dim=12, acoustic_dim=4, decoder_dim=16, rates=(2, 5))
TOL = 1e-5


# ------------------------------------------------------------------ files

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int64, torch.bfloat16],
                         ids=str)
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        make = lambda s: torch.randint(-2**40, 2**40, s, generator=g, dtype=dtype)  # noqa: E731
    sd = {"a.weight": make((3, 5)), "b": make((7,)), "scalar": make(()), "empty": make((0, 4)),
          "z.last": make((2, 3, 4))}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = TV.read_safetensors(path)
    assert set(got) == set(sd)
    want = torch_load_file(path) if dtype == torch.bfloat16 else {
        k: torch.from_numpy(v) for k, v in np_load_file(path).items()}
    for k, v in want.items():
        assert got[k].dtype == v.dtype == dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v), k
    assert TV.torch_load_weights(path).keys() == sd.keys()


def test_torch_load_weights_other_formats(tmp_path):
    sd = {"w": torch.randn(3, 2), "n": torch.arange(4)}
    torch.save({"state_dict": sd}, tmp_path / "x.pth")
    got = TV.torch_load_weights(str(tmp_path / "x.pth"))["state_dict"]
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    np.savez(tmp_path / "x.npz", **{k: v.numpy() for k, v in sd.items()})
    got = TV.torch_load_weights(str(tmp_path / "x.npz"))
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_fold_weight_norm_matches_jax_and_torch():
    g = torch.Generator().manual_seed(1)
    v = torch.randn(6, 4, 5, generator=g)
    gg = torch.rand(6, 1, 1, generator=g) + 0.5
    want = JV.fold_weight_norm(gg.numpy(), v.numpy(), dim=0)
    got = TV.fold_weight_norm(gg, v, dim=0)
    np.testing.assert_array_equal(got.numpy(), want)
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 5))
    old = torch.nn.utils.weight_norm(torch.nn.ConvTranspose1d(6, 4, 5))
    for mod in (conv, old):
        sd = TV.fold_state_dict(mod.state_dict())
        assert set(sd) == {"weight", "bias"}
        torch.testing.assert_close(sd["weight"], mod.weight.detach(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        TV.fold_weight_norm(torch.ones(1, 1, 5), v, dim=2).numpy(),
        JV.fold_weight_norm(np.ones((1, 1, 5), np.float32), v.numpy(), dim=2))


# ------------------------------------------------------------------ LLaMA

def llama_config(vocab: int, **kw) -> dict:
    """An HF LlamaConfig's config.json for a 2-layer GQA model."""
    return dict(architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=vocab,
                hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
                rms_norm_eps=1e-6, rope_theta=10000.0, torch_dtype="bfloat16",
                tie_word_embeddings=False, **kw)


def llama_state(cfg: dict, seed: int, tied: bool = False) -> dict:
    """A LLaMA state_dict under HF's names with seeded values rounded to bf16
    (stored as fp32), plus a legacy rotary buffer the loaders must skip."""
    lm = TL.TransformerLM(TL.LMConfig(vocab_size=cfg["vocab_size"], dim=32, n_layers=2,
                                      n_heads=4, n_kv_heads=2, ffn_dim=64, dtype="float32"))
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in lm.state_dict().items():
        scale = 0.1 if k.endswith("norm.weight") else 1.0 / np.sqrt(v.shape[-1])
        base = 1.0 if k.endswith("norm.weight") else 0.0
        sd[k] = (base + scale * torch.randn(v.shape, generator=g)).bfloat16().float()
    if tied:
        del sd["lm_head.weight"]
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(4)
    return sd


def write_llama_dir(d, vocab: int, seed: int, shards: int = 1, tied: bool = False) -> dict:
    os.makedirs(d, exist_ok=True)
    cfg = llama_config(vocab)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    sd = llama_state(cfg, seed, tied)
    if shards == 1:
        save_file(sd, os.path.join(d, "model.safetensors"))
        return sd
    keys = sorted(sd)
    per = -(-len(keys) // shards)
    weight_map = {}
    for si in range(shards):
        name = f"model-{si + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: sd[k] for k in keys[si * per:(si + 1) * per]}
        save_file(part, os.path.join(d, name))
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return sd


def test_sharded_hf_dir_and_its_config(tmp_path):
    d = str(tmp_path / "lm")
    sd = write_llama_dir(d, 64, seed=2, shards=3)
    got = TV.load_hf_dir_weights(d)
    want = JV.load_hf_dir_weights(d)
    assert set(got) == set(sd) == set(want)
    for k, v in sd.items():
        assert torch.equal(got[k], v) and np.array_equal(want[k], v.numpy()), k
    cfg, jcfg = TV.lm_config_from_hf_dir(d), JV.lm_config_from_hf_dir(d)
    assert vars(cfg) == vars(jcfg)
    assert (cfg.n_kv_heads, cfg.norm_eps, cfg.dtype) == (2, 1e-6, "bfloat16")
    assert TV.lm_config_from_hf_dir(d, dtype="float32").dtype == "float32"
    with pytest.raises(FileNotFoundError):
        TV.load_hf_dir_weights(str(tmp_path))


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_load_llama_checkpoint_matches_jax(tmp_path, tied):
    """One file; without ``lm_head`` the head is the embedding table.  The
    port's fp32 model and the JAX package's loaded tree: logits to 1e-5."""
    d = str(tmp_path / "lm")
    sd = write_llama_dir(d, 64, seed=3, tied=tied)
    path = os.path.join(d, "model.safetensors")
    cfg = TV.lm_config_from_hf_dir(d, dtype="float32")
    tm = TV.load_llama_checkpoint(path, cfg, device="cpu")
    emb = sd["model.embed_tokens.weight"]
    assert torch.equal(tm.lm_head.weight, emb if tied else sd["lm_head.weight"])
    jcfg = JV.lm_config_from_hf_dir(d, dtype="float32")
    jp = JV.load_llama_checkpoint(path, jcfg)
    toks = np.random.default_rng(4).integers(0, 64, (2, 9))
    want = np.asarray(jax.jit(JL.TransformerLM(jcfg).apply)({"params": jp},
                                                            jnp.asarray(toks))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))[0]
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    broken = dict(sd)
    del broken["model.norm.weight"]
    save_file(broken, path)
    with pytest.raises(KeyError, match="model.norm.weight"):
        TV.load_llama_checkpoint(path, cfg, device="cpu")


# ------------------------------------------------------------------ xcodec

def write_xcodec(path, seed: int) -> dict:
    """The reference layout's decoder (weight-normed, tests/torch_ref_models.py)
    saved as ``{"codec_model": ...}`` with ``model.`` prefixes and an encoder
    tensor the decode path does not use."""
    from tests.torch_ref_models import XCodecDecoderTorch

    torch.manual_seed(seed)
    ref = XCodecDecoderTorch(n_q=XC["n_q"], bins=XC["codebook_size"], dim=XC["dim"],
                             acoustic=XC["acoustic_dim"], dec_dim=XC["decoder_dim"],
                             rates=XC["rates"]).eval()
    sd = {f"model.{k}": v for k, v in ref.state_dict().items()}
    sd["model.encoder.conv.weight"] = torch.zeros(3)
    torch.save({"codec_model": sd}, path)
    return ref


def test_load_xcodec_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "final.pth")
    ref = write_xcodec(path, seed=5)
    tm = TV.load_xcodec_checkpoint(path, TC.XCodecConfig(**XC), device="cpu")
    jp = JV.load_xcodec_checkpoint(path, JC.XCodecConfig(**XC))
    want_sd = W.xcodec_from_jax(jp)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    codes = np.random.default_rng(6).integers(0, XC["codebook_size"], (2, XC["n_q"], 8))
    want = np.asarray(JC.XCodecDecoder(JC.XCodecConfig(**XC)).apply(
        {"params": jp}, jnp.asarray(codes)))
    with torch.no_grad():
        got = tm(torch.from_numpy(codes)).numpy()
        witness = ref(torch.from_numpy(codes))[:, 0].numpy()
    assert got.shape == (2, 80)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert np.abs(got - witness).max() <= TOL * np.abs(witness).max()


# ------------------------------------------------------------------ YuE's stack

def write_yue_stack(root) -> dict:
    vocab = TY.YuEVocab(**VOCAB).size
    paths = dict(s1=str(root / "stage1"), s2=str(root / "stage2"),
                 xcodec=str(root / "final.pth"), tok=str(root / "tokenizer.model"))
    write_llama_dir(paths["s1"], vocab, seed=7)
    write_llama_dir(paths["s2"], vocab, seed=8, shards=3)
    write_xcodec(paths["xcodec"], seed=9)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -2.0, 1),
              ("▁la", -3.0, 1), ("▁pop", -3.5, 1)]
    pieces += [(ch, -8.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz[]_.\n"]
    with open(paths["tok"], "wb") as f:
        f.write(TS.build_model_proto(pieces, model_type=TS.UNIGRAM))
    return paths


def fp32_lm(jp_or_tp, stage: str):
    """The stage's LM computing in fp32 on the same (bf16-exact) weights."""
    if isinstance(jp_or_tp, JY.YuEPipeline):
        return JL.TransformerLM(dataclasses.replace(getattr(jp_or_tp.cfg, stage),
                                                    dtype="float32"))
    lm = getattr(jp_or_tp, f"s{stage[-1]}")
    out = TL.TransformerLM(dataclasses.replace(lm.cfg, dtype="float32"))
    out.load_state_dict({k: v.float() for k, v in lm.state_dict().items()})
    return out.eval()


def test_load_yue_pipeline_matches_jax(tmp_path, caplog):
    """Both packages' ``load_yue_pipeline`` on the stack the test writes (stage
    1 in one file, stage 2 in three shards with an index, the xcodec .pth,
    the mm tokenizer): the same weights and tokens, identical stage-1 codes
    under the JAX keys' draws and identical stage-2 codes in fp32, and
    ``generate_music`` on the xcodec path within 1e-5 of max|y|."""
    p = write_yue_stack(tmp_path)
    jp = JV.load_yue_pipeline(p["s1"], p["s2"], p["xcodec"], tokenizer_model=p["tok"],
                              xcodec_cfg=JC.XCodecConfig(**XC), vocab=JY.YuEVocab(**VOCAB))
    tp = TV.load_yue_pipeline(p["s1"], p["s2"], p["xcodec"], tokenizer_model=p["tok"],
                              xcodec_cfg=TC.XCodecConfig(**XC), vocab=TY.YuEVocab(**VOCAB),
                              device="cpu")
    assert tp.device.type == "cpu" and tp.cfg.stage1.dtype == "bfloat16"
    assert vars(tp.cfg.stage1) == vars(jp.cfg.stage1) and vars(tp.cfg.stage2) == vars(
        jp.cfg.stage2)
    for stage, tree in (("s1", jp.s1_params), ("s2", jp.s2_params)):
        want = W.lm_from_jax(tree)
        for k, v in getattr(tp, stage).state_dict().items():
            assert torch.equal(v.float(), want[k]), (stage, k)
    want = W.xcodec_from_jax(jp.xcodec_params)
    assert all(torch.equal(v, want[k]) for k, v in tp.xcodec.state_dict().items())
    text = "[Genre] pop\nla la <SOA>"
    assert tp.tokenizer.tokenize(text) == jp.tokenizer.tokenize(text)
    assert tp._tok(text).tolist() == jp._tok(text).tolist()

    # both stacks in fp32 and with 16-frame stage-2 blocks (the loaders'
    # YuEConfig takes the published 300)
    jp.s1, jp.s2 = fp32_lm(jp, "stage1"), fp32_lm(jp, "stage2")
    tp.s1, tp.s2 = fp32_lm(tp, "stage1"), fp32_lm(tp, "stage2")
    jp.cfg.stage2_block = tp.cfg.stage2_block = 16
    prompt, vf = jp._prompt("pop", "la la la")
    t_prompt, t_vf = tp._prompt("pop", "la la la")
    np.testing.assert_array_equal(t_prompt, np.asarray(prompt))
    frames, v = 10, tp.cfg.vocab
    c1 = np.asarray(JY.stage1_generate(jp.s1, jp.s1_params, prompt, frames, jp.cfg.vocab,
                                       valid_from=vf, rng=jax.random.PRNGKey(0)))
    got = TY.stage1_generate(tp.s1, t_prompt, frames, v, valid_from=t_vf,
                             draws=tiny.jax_draws(0, 2 * frames, 1, v.size), device="cpu")
    np.testing.assert_array_equal(got.numpy(), c1)
    c2 = np.asarray(JY.stage2_generate(jp.s2, jp.s2_params, jnp.asarray(c1), jp.cfg.vocab,
                                       n_q=8, block=16))
    np.testing.assert_array_equal(TY.stage2_generate(tp.s2, c1, v, n_q=8, block=16,
                                                     device="cpu").numpy(), c2)
    tp.draws = lambda seed, shape: tiny.jax_draws(seed, shape[0], 1, shape[2])
    want = jp.generate_music("pop", "la la la", seconds_per_segment=0.2, seed=0)
    got = tp.generate_music("pop", "la la la", seconds_per_segment=0.2, seed=0)
    assert got["sr"] == want["sr"] == 500 and got["mix"].shape == want["mix"].shape == (100,)
    for k in ("vocal", "inst"):
        assert np.abs(got[k] - want[k]).max() <= TOL * np.abs(want[k]).max(), k

    with caplog.at_level(logging.WARNING, logger="audiolab_tpu_torch.utils.convert"):
        TV.load_yue_pipeline(p["s1"], p["s2"], p["xcodec"], xcodec_cfg=TC.XCodecConfig(**XC),
                             device="cpu")
    assert "stage-1 vocab 422 != mm-v0.2 layout 83734" in caplog.text
