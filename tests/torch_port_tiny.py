"""Tiny models shared by the port's parity tests, built without a flax init.

A flax ``init`` of the synthesizer, HuBERT or RMVPE costs tens of seconds
on the CPU.  Here each model is made as a port module with seeded random
weights (every float parameter and buffer moved off its initial value,
batch-norm variances in [0.5, 1.5)), the JAX package's converter maps its
state_dict onto a template from ``jax.eval_shape`` (tracing only), and the
port's ``*_from_jax`` carries the flax tree back into the port module that
the tests use, so both packages hold the same numbers and the round trip is
exercised on the way."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import zonos as JZ
from audiolab_tpu.models import rmvpe as JRm
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.models.separation import htdemucs as JHt
from audiolab_tpu.models.separation import mdx23c as JMc
from audiolab_tpu.utils.convert import (
    convert_htdemucs,
    convert_hubert,
    convert_mdx23c,
    convert_rmvpe,
    convert_rvc,
)
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import zonos as TZ
from audiolab_tpu_torch.models import rmvpe as TRm
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.models.separation import htdemucs as THt
from audiolab_tpu_torch.models.separation import mdx23c as TMc
from audiolab_tpu_torch.utils import weights as W

HCFG = dict(dim=32, ffn_dim=64, heads=4, layers=2, final_dim=16)
RM_SIZES = dict(en_de_layers=2, inter_layers=1, n_blocks=1, en_out_channels=4, gru_hidden=8)
# tests/test_htdemucs_parity.py's and tests/test_mdx23c_parity.py's tiny sizes
HTD = dict(sources=("vocals", "other"), audio_channels=2, channels=4, growth=2, nfft=128,
           depth=2, kernel_size=8, stride=4, norm_starts=4, norm_groups=2, dconv_depth=2,
           dconv_comp=2, bottom_channels=8, t_layers=3, t_heads=2, t_hidden_scale=2.0,
           segment_seconds=1.0, samplerate=800)
MDXC = dict(sample_rate=8000, n_fft=256, hop_length=64, dim_f=128, num_channels=2,
            num_subbands=2, num_scales=2, scale=(2, 2), num_blocks_per_scale=1, channels=8,
            growth=8, bottleneck_factor=2, norm="InstanceNorm", act="gelu",
            instruments=("Vocals", "Instrumental"), target_instrument=None)
# Zonos at test width: both mixers take it (d_inner 64 = 4 Mamba2 heads of 16)
ZONOS = dict(dim=32, n_layers=3, attn_every=3, n_heads=4, d_state=4, n_codebooks=3,
             codebook_size=34, spk_dim=16, headdim=16)
DAC = dict(dim=16, rates=(8, 8, 4, 2), n_q=3, codebook_size=34, codebook_dim=8,
           decoder_dim=32)
SYNTH = dict(spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
             spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread (imported by a test module, it is
    autouse there): its small convolutions, recurrences and attention ops
    run fastest so, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(make, seed: int, scale: float = 0.1) -> torch.nn.Module:
    """``make()``'s module with weights that depend on ``seed`` alone: built
    under a forked, seeded global generator (torch's default inits draw
    from it), then every float parameter and buffer moved off its value."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        module = make()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            else:
                t.add_(scale * torch.randn(t.shape, generator=g))
    return module.eval()


def _numpy(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def synth(seed: int = 1):
    """(flax params, port SynthesizerTrn) at the SYNTH configuration."""
    t = 8
    cfg = JSy.SynthesizerConfig(**SYNTH)
    tpl = jax.eval_shape(lambda: JSy.SynthesizerTrn(cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, t, 32)), jnp.full((1,), t, jnp.int32),
        jnp.ones((1, t), jnp.int32), jnp.full((1, t), 200.0), jnp.zeros((1,), jnp.int32), None,
        method=JSy.SynthesizerTrn.infer))["params"]
    src = seeded(lambda: TSy.SynthesizerTrn(TSy.SynthesizerConfig(**SYNTH)), seed, 0.05)
    p = _f32(convert_rvc(_numpy(src), tpl))
    tm = TSy.SynthesizerTrn(TSy.SynthesizerConfig(**SYNTH))
    tm.load_state_dict(W.synthesizer_from_jax(p), strict=True)
    return p, tm.eval()


@functools.lru_cache(maxsize=None)
def hubert(version: str = "v2", seed: int = 2):
    """(flax params, port HubertFeatureExtractor) at the HCFG configuration."""
    jm = JH.HubertFeatureExtractor(version=version, cfg=JH.HubertConfig(**HCFG))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000))))["params"]
    src = seeded(lambda: TH.HubertFeatureExtractor(version, TH.HubertConfig(**HCFG)), seed)
    p = _f32(convert_hubert(_numpy(src), tpl))
    tm = TH.HubertFeatureExtractor(version, TH.HubertConfig(**HCFG))
    tm.load_state_dict(W.hubert_from_jax(p), strict=True)
    return p, tm.eval()


@functools.lru_cache(maxsize=None)
def rmvpe(seed: int = 3):
    """(JAX RMVPE holding the variables, port RMVPE), both fp32."""
    e2e = JRm.E2E(**RM_SIZES)
    tpl = jax.eval_shape(lambda: e2e.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 128))))
    src = seeded(lambda: TRm.RMVPE(dtype=None, **RM_SIZES), seed)
    v = _f32(convert_rmvpe(_numpy(src), {"params": tpl["params"],
                                         "batch_stats": tpl["batch_stats"]}))
    j = JRm.RMVPE(dtype=None)
    j.model = e2e
    j.variables = v
    tm = TRm.RMVPE(dtype=None, **RM_SIZES)
    tm.load_state_dict(W.rmvpe_from_jax(v["params"], v["batch_stats"]), strict=True)
    return j, tm.eval()


def _frozen(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _htdemucs(frozen: tuple, seed: int):
    kw = dict(frozen)
    n = int(kw["segment_seconds"] * kw["samplerate"])
    jm = JHt.HTDemucs(JHt.HTDemucsConfig(**kw))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, n))))["params"]
    src = seeded(lambda: THt.HTDemucs(THt.HTDemucsConfig(**kw)), seed)
    p = _f32(convert_htdemucs(_numpy(src), tpl, strict=True))
    tm = THt.HTDemucs(THt.HTDemucsConfig(**kw))
    tm.load_state_dict(W.htdemucs_from_jax(p), strict=True)
    return p, tm.eval()


def htdemucs(seed: int = 4, **kw):
    """(flax params, port HTDemucs) at HTD updated by ``kw``."""
    return _htdemucs(_frozen(dict(HTD, **kw)), seed)


@functools.lru_cache(maxsize=None)
def _mdx23c(frozen: tuple, seed: int):
    kw = dict(frozen)
    jm = JMc.TFCTDFNetV3(JMc.MDX23CConfig(**kw))
    n = jm.good_length(0.25)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, n))))["params"]
    src = seeded(lambda: TMc.TFCTDFNetV3(TMc.MDX23CConfig(**kw)), seed)
    p = _f32(convert_mdx23c(_numpy(src), tpl, strict=True))
    tm = TMc.TFCTDFNetV3(TMc.MDX23CConfig(**kw))
    tm.load_state_dict(W.mdx23c_from_jax(p), strict=True)
    return p, tm.eval()


def mdx23c(seed: int = 5, **kw):
    """(flax params, port TFCTDFNetV3) at MDXC updated by ``kw``."""
    return _mdx23c(_frozen(dict(MDXC, **kw)), seed)


def filled(template, seed: int):
    """A flax parameter tree of ``template``'s shapes (from ``jax.eval_shape``)
    with seeded numpy values scaled per leaf: kernels N(0, 1/fan_in), norm
    scales 1 + 0.1 N, biases 0.05 N, embeddings and relative banks 0.3 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(x.shape)
        if name == "kernel":
            z = z / np.sqrt(max(1, int(np.prod(x.shape[:-1]))))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "bias":
            z = 0.05 * z
        else:
            z = 0.3 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)


@functools.lru_cache(maxsize=None)
def train_pair(periods: tuple = (2, 3), seed: int = 4):
    """(flax G params with enc_q, flax D params, port G, port D) at the SYNTH
    configuration (tests/test_train.py's ``tiny_cfg``): the G template is
    the port module's tree under flax names (``synthesizer_to_jax``; no
    flax ``init``, and a wrong name or shape would fail the JAX ``apply``),
    the D template comes from ``jax.eval_shape``; both are filled by
    :func:`filled` and carried into the port by ``synthesizer_from_jax`` /
    ``discriminator_from_jax``."""
    from audiolab_tpu.models.rvc import discriminator as JD
    from audiolab_tpu_torch.models.rvc import discriminator as TD

    cfg = TSy.SynthesizerConfig(**SYNTH)
    g_tpl = W.synthesizer_to_jax(TSy.SynthesizerTrn(cfg, posterior=True).state_dict())
    seg = cfg.segment_size
    d_tpl = jax.eval_shape(lambda: JD.MultiPeriodDiscriminatorV2(periods).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seg, 1)), jnp.zeros((1, seg, 1))))["params"]
    gp, dp = filled(g_tpl, seed), filled(d_tpl, seed + 1)
    tg = TSy.SynthesizerTrn(cfg, posterior=True)
    tg.load_state_dict(W.synthesizer_from_jax(gp), strict=True)
    td = TD.MultiPeriodDiscriminatorV2(periods)
    td.load_state_dict(W.discriminator_from_jax(dp), strict=True)
    return gp, dp, tg, td


@functools.lru_cache(maxsize=None)
def _zonos(frozen: tuple, seed: int):
    kw = dict(frozen)
    cfg = JZ.ZonosConfig(**kw)
    bos = jnp.full((1, cfg.n_codebooks, 1), cfg.masked_id, jnp.int32)
    tpl = jax.eval_shape(lambda: JZ.ZonosModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, cfg.spk_dim)),
        jnp.zeros((1, 8)), jnp.zeros((1, 1)), jnp.zeros((1, 1)), bos, 16,
        method=JZ.ZonosModel.prefill))["params"]
    p = filled(tpl, seed)
    tm = TZ.ZonosModel(TZ.ZonosConfig(**kw))
    tm.load_state_dict(W.zonos_from_jax(p), strict=True)
    return cfg, p, tm.eval()


def zonos(mixer: str = "mamba1", seed: int = 6, **kw):
    """(JAX ZonosConfig, flax params from :func:`filled`, port ZonosModel) at
    ZONOS updated by ``kw``."""
    return _zonos(_frozen(dict(ZONOS, mixer=mixer, **kw)), seed)


@functools.lru_cache(maxsize=None)
def _dac(frozen: tuple, seed: int, kernel_scale: float):
    kw = dict(frozen)
    cfg = JC.DACConfig(**kw)
    tpl = jax.eval_shape(lambda: JC.DACDecoder(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.n_q, 4), jnp.int32)))["params"]
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: (kernel_scale * a).astype(np.float32)
        if str(getattr(path[-1], "key", "")) == "kernel" else a, filled(tpl, seed))
    tm = TC.DACDecoder(TC.DACConfig(**kw))
    tm.load_state_dict(W.dac_from_jax(p), strict=True)
    return cfg, p, tm.eval()


def dac(seed: int = 7, kernel_scale: float = 0.5, **kw):
    """(JAX DACConfig, flax params, port DACDecoder) at DAC updated by
    ``kw``, the filler's kernels times ``kernel_scale``.  At the default
    half scale every activation stays below 1 and the output at speech
    level (peak about 0.13), so fp32 rounding is held against the output's
    own scale; at full scale the residual stack grows the activations to
    ~20 and the tanh clips the output at 1."""
    return _dac(_frozen(dict(DAC, **kw)), seed, kernel_scale)


@functools.lru_cache(maxsize=None)
def speaker_encoder(out_dim: int = 16, seed: int = 8):
    """(flax params, port SpeakerEncoder) on 80 mel bands."""
    tpl = jax.eval_shape(lambda: JZ.SpeakerEncoder(out_dim).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 80))))["params"]
    p = filled(tpl, seed)
    tm = TZ.SpeakerEncoder(out_dim)
    tm.load_state_dict(W.speaker_encoder_from_jax(p), strict=True)
    return p, tm.eval()


def jax_draws(seed: int, total: int, rows: int, vocab: int) -> np.ndarray:
    """The Gumbel draws the JAX Zonos decode takes from ``PRNGKey(seed)``:
    ``rng, key = split(rng)`` every step, then ``categorical(key, flat)``,
    which is argmax(flat + gumbel(key, flat.shape))."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(total):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(key, (rows, vocab), jnp.float32)))
    return np.stack(out)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _dia_draws(key, total: int, b: int, n_q: int, vocab: int):
    def body(rng, _):
        rng, key = jax.random.split(rng)
        keys = jax.random.split(key, n_q)
        g = jax.vmap(lambda k: jax.random.gumbel(k, (b, vocab), jnp.float32))(keys)
        return rng, jnp.swapaxes(g, 0, 1).reshape(b * n_q, vocab)

    return jax.lax.scan(body, key, None, length=total)[1]


def jax_dia_draws(seed: int, total: int, b: int, n_q: int, vocab: int) -> np.ndarray:
    """The Gumbel draws the JAX Dia decode takes from ``PRNGKey(seed)``: every
    step ``rng, key = split(rng)``, ``keys = split(key, n_q)``, then
    ``categorical(keys[q], (b, vocab))`` for each codebook; row bi * n_q + q
    of each step's (b * n_q, vocab) block."""
    return np.array(_dia_draws(jax.random.PRNGKey(seed), total, b, n_q, vocab))


# Dia at test width: decoder GQA (4 query heads over 2) with head dims that
# are not dim / heads, and a narrower encoder
DIA = dict(dim_enc=16, dim_dec=32, n_layers_enc=1, n_layers_dec=2, n_heads=4, kv_heads=2,
           head_dim_dec=12, cross_head_dim=10, n_heads_enc=2, n_codebooks=3,
           codebook_size=20, max_text_len=32, max_audio_len=48)


@functools.lru_cache(maxsize=None)
def _dia(frozen: tuple, seed: int):
    from audiolab_tpu.models import dia as JD
    from audiolab_tpu_torch.models import dia as TD

    kw = dict(frozen)
    cfg = JD.DiaConfig(**kw)
    jm = JD.DiaModel(cfg)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                         jnp.zeros((1, cfg.n_codebooks, 4), jnp.int32)))["params"]
    p = filled(tpl, seed)
    tcfg = TD.DiaConfig(**kw)
    tm = TD.DiaModel(tcfg)
    tm.load_state_dict(W.dia_from_jax(p, tcfg), strict=True)
    return cfg, jm, p, tm.eval()


def dia(seed: int = 9, **kw):
    """(JAX DiaConfig, JAX DiaModel, flax params from :func:`filled`, port
    DiaModel) at DIA updated by ``kw``."""
    return _dia(_frozen(dict(DIA, **kw)), seed)


class Jitted:
    """A flax module whose ``apply`` runs jitted (one compile per keyword
    set): the JAX engines call their modules' ``apply`` op by op, which costs
    seconds on the CPU; the engines' own code is unchanged."""

    def __init__(self, module):
        self.module, self._fns = module, {}

    def apply(self, variables, *args, **kw):
        key = tuple(sorted(kw.items(), key=lambda kv: kv[0]))
        if key not in self._fns:
            self._fns[key] = jax.jit(functools.partial(self.module.apply, **kw))
        return self._fns[key](variables, *args)

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __hash__(self):
        return hash(self.module)


# the capability XTTS at test width (the JAX engine's modules jitted)
XTTS = dict(dim=32, n_layers=2, n_heads=4, cond_latents=4, n_codes=60, max_seq_len=128)


@functools.lru_cache(maxsize=None)
def xtts(seed: int = 30):
    """(JAX XTTS, port XTTS on the CPU) at XTTS holding the same weights: the
    JAX tree from ``jax.eval_shape`` templates and :func:`filled`, carried into
    the port by ``xtts_from_jax``."""
    from audiolab_tpu.models import xtts as JX
    from audiolab_tpu_torch.models import xtts as TX

    cfg = JX.XTTSConfig(**XTTS)
    mods = (JX.ConditioningEncoder(cfg), JX.XttsGPT(cfg), JX.XttsVocoder(cfg))
    caches = JX.init_cache(cfg.lm(), 1, cfg.max_seq_len)
    tpl = {
        "cond": jax.eval_shape(lambda: mods[0].init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 16, 80))))["params"],
        "gpt": jax.eval_shape(lambda: mods[1].init(
            jax.random.PRNGKey(0), jnp.zeros((1, cfg.cond_latents, cfg.dim)),
            jnp.zeros((1, 4), jnp.int32), caches, method=JX.XttsGPT.prefill))["params"],
        "vocoder": jax.eval_shape(lambda: mods[2].init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
            jnp.zeros((1, cfg.dim))))["params"],
    }
    params = {k: filled(t, seed + i) for i, (k, t) in enumerate(tpl.items())}
    tcfg = TX.XTTSConfig(**XTTS)
    tmods = (TX.ConditioningEncoder(tcfg), TX.XttsGPT(tcfg), TX.XttsVocoder(tcfg))
    holder = torch.nn.ModuleDict(dict(zip(("cond_enc", "gpt", "vocoder"), tmods)))
    holder.load_state_dict(W.xtts_from_jax(params), strict=True)
    jx = JX.XTTS(cfg, params)
    jx.cond_enc, jx.vocoder = Jitted(jx.cond_enc), Jitted(jx.vocoder)
    return jx, TX.XTTS(tcfg, *tmods, device="cpu")


# ------------------------------------------------------------- Chatterbox
# the JAX package's tiny Chatterbox (pipelines/tts.py::random_chatterbox and
# tests/test_chatterbox_engine.py), the S3 tokenizer narrow but on 128 mels
# (tokenize_wav's front end), CAMPPlus and WeSpeaker as the JAX parity tests'
T3_TINY = dict(text_vocab=40, speech_vocab=36, dim=32, n_layers=2, n_heads=4, ffn_dim=64,
               max_text_tokens=64, max_speech_tokens=64, speaker_embed_size=8,
               perceiver_tokens=4, perceiver_heads=2, start_text_token=38, stop_text_token=0,
               start_speech_token=30, stop_speech_token=31)
FLOW_TINY = dict(token_vocab=30, dim=32, mel_dim=8, xvector_dim=12, heads=2, ffn_dim=64,
                 n_layers=2, n_up_layers=1, est_channels=16, est_mid_blocks=2, est_n_blocks=1,
                 est_heads=2, est_head_dim=4, n_timesteps=2)
# HiFT with two resblock kernels of two dilations (the JAX tests' three of
# three cost seconds of XLA compile per shape; the layout is the same)
HIFT_TINY = dict(in_channels=8, base_channels=16, f0_cond_channels=12,
                 resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)),
                 source_resblock_dilations=((1, 3), (1, 3), (1, 3)))
CAMPPLUS_TINY = dict(feat_dim=16, embedding_size=12, growth_rate=4, bn_size=2, init_channels=8,
                     m_channels=4, block_layers=(2, 3), block_kernels=(3, 3),
                     block_dilations=(1, 2), seg_len=5)
S3TOK_TINY = dict(n_mels=128, n_state=32, n_head=4, n_layer=2, n_ctx=256, fsmn_kernel=7,
                  fsq_dim=3)
WESPEAKER_TINY = dict(feat_dim=16, embed_dim=24, m_channels=8, num_blocks=(1, 2, 1, 1))


def _positive(tree, seed: int):
    """``tree`` with BatchNorm variances in [0.5, 1.5) and Snake alphas near 1
    (the filler's 0.3 N would make them negative or near 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        if name == "alpha":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@functools.lru_cache(maxsize=None)
def chatterbox_t3(seed: int = 40, **kw):
    """(JAX T3CkptConfig, flax template, flax params, port T3) at T3_TINY updated
    by ``kw``; the template holds the perceiver (a prompt at init)."""
    from audiolab_tpu.models import chatterbox_t3 as JT3
    from audiolab_tpu_torch.models import chatterbox_t3 as TT3

    c = dict(T3_TINY, **kw)
    cfg = JT3.T3CkptConfig(**c)
    tpl = jax.eval_shape(lambda: JT3.T3(cfg, max_seq_len=256).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, cfg.speaker_embed_size)), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1,))))["params"]
    p = filled(tpl, seed)
    return cfg, tpl, p, _load(TT3.T3(TT3.T3CkptConfig(**c), max_seq_len=256),
                              W.chatterbox_t3_from_jax(p))


@functools.lru_cache(maxsize=None)
def voice_encoder(seed: int = 41):
    """(flax template, flax params, port VoiceEncoder) at VoiceEncoderConfig()."""
    from audiolab_tpu.models import chatterbox_t3 as JT3
    from audiolab_tpu_torch.models import chatterbox_t3 as TT3

    tpl = jax.eval_shape(lambda: JT3.VoiceEncoder().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 40))))["params"]
    p = jax.tree_util.tree_map(lambda a: (a / 3).astype(np.float32), filled(tpl, seed))
    return tpl, p, _load(TT3.VoiceEncoder(), W.voice_encoder_from_jax(p))


@functools.lru_cache(maxsize=None)
def s3gen(seed: int = 42):
    """(JAX FlowConfig, HiFTConfig, flow template, flow params, HiFT template,
    HiFT params, port S3Token2Wav) at FLOW_TINY / HIFT_TINY."""
    from audiolab_tpu.models import chatterbox_s3gen as JS
    from audiolab_tpu_torch.models import chatterbox_s3gen as TS

    fcfg, hcfg = JS.FlowConfig(**FLOW_TINY), JS.HiFTConfig(**HIFT_TINY)
    ftpl = jax.eval_shape(lambda: JS.CausalMaskedDiffWithXvec(fcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32), jnp.zeros((1, fcfg.xvector_dim)),
        jnp.zeros((1, 2, fcfg.mel_dim)), jnp.zeros((1, 6, fcfg.mel_dim))))["params"]
    htpl = jax.eval_shape(lambda: JS.HiFTGenerator(hcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, hcfg.in_channels)),
        jax.random.PRNGKey(1)))["params"]
    fp, hp = filled(ftpl, seed), _positive(filled(htpl, seed + 1), seed + 2)
    m = TS.S3Token2Wav(TS.FlowConfig(**FLOW_TINY), TS.HiFTConfig(**HIFT_TINY))
    sd = {**W.s3gen_flow_from_jax(fp, "flow."), **W.hift_from_jax(hp, "mel2wav.")}
    return fcfg, hcfg, ftpl, fp, htpl, hp, _load(m, sd)


@functools.lru_cache(maxsize=None)
def campplus(seed: int = 43):
    """(JAX CAMPPlusConfig, flax template, flax params, port CAMPPlus)."""
    from audiolab_tpu.models import campplus as JCp
    from audiolab_tpu_torch.models import campplus as TCp

    cfg = JCp.CAMPPlusConfig(**CAMPPLUS_TINY)
    tpl = jax.eval_shape(lambda: JCp.CAMPPlus(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, cfg.feat_dim))))["params"]
    p = _positive(filled(tpl, seed), seed + 1)
    return cfg, tpl, p, _load(TCp.CAMPPlus(TCp.CAMPPlusConfig(**CAMPPLUS_TINY)),
                              W.campplus_from_jax(p))


@functools.lru_cache(maxsize=None)
def s3tokenizer(seed: int = 44):
    """(JAX S3TokenizerConfig, flax template, flax params, port S3TokenizerV2)."""
    from audiolab_tpu.models import s3tokenizer as JS3
    from audiolab_tpu_torch.models import s3tokenizer as TS3

    cfg = JS3.S3TokenizerConfig(**S3TOK_TINY)
    tpl = jax.eval_shape(lambda: JS3.S3TokenizerV2(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, cfg.n_mels))))["params"]
    p = filled(tpl, seed)
    return cfg, tpl, p, _load(TS3.S3TokenizerV2(TS3.S3TokenizerConfig(**S3TOK_TINY)),
                              W.s3tokenizer_from_jax(p))


@functools.lru_cache(maxsize=None)
def wespeaker(seed: int = 45, **kw):
    """(JAX WeSpeakerConfig, flax template, flax params, port WeSpeakerResNet)
    at WESPEAKER_TINY updated by ``kw``."""
    from audiolab_tpu.models import wespeaker as JWs
    from audiolab_tpu_torch.models import wespeaker as TWs

    c = dict(WESPEAKER_TINY, **kw)
    cfg = JWs.WeSpeakerConfig(**c)
    tpl = jax.eval_shape(lambda: JWs.WeSpeakerResNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 50, cfg.feat_dim))))["params"]
    p = filled(tpl, seed)
    return cfg, tpl, p, _load(TWs.WeSpeakerResNet(TWs.WeSpeakerConfig(**c)),
                              W.wespeaker_from_jax(p))


def jax_t3_draws(seed: int, max_new_tokens: int, vocab: int) -> np.ndarray:
    """The Gumbel draws the JAX t3_generate takes from ``PRNGKey(seed)``:
    ``rng, key0 = split(PRNGKey(seed))`` for the first token, then ``rng, key
    = split(rng)`` every step, each ``categorical(key, (1, vocab))``;
    (max_new_tokens + 1, 1, vocab)."""
    return jax_draws(seed, max_new_tokens + 1, 1, vocab)


def jax_hift_draws(seed: int, b: int, n: int, harmonics: int) -> tuple[np.ndarray, np.ndarray]:
    """The NSF source draws HiFT takes from ``PRNGKey(seed)``: the initial
    phases ``uniform(rng, (b, 1, H))`` and the noise ``normal(fold_in(rng, 1),
    (b, n, H))``."""
    rng = jax.random.PRNGKey(seed)
    return (np.asarray(jax.random.uniform(rng, (b, 1, harmonics))),
            np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), (b, n, harmonics))))


def numpy_state(module: torch.nn.Module) -> dict:
    """A port module's state_dict as numpy arrays (a converter's input)."""
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def assert_tree_equal(a, b) -> None:
    """Two flax trees with the same leaves, each to fp32 rounding (the
    converters' BatchNorm folds run in float64)."""
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def chatterbox_engines(encoders: bool = False):
    """(JAX ChatterboxCheckpointEngine, port ChatterboxCheckpointEngine on the
    CPU) on the same weights: the tiny T3, flow and HiFT, and with
    ``encoders`` the published-width voice encoder, the tiny CAMPPlus and S3
    tokenizer (its 27 codes inside the flow's 30).  The JAX engine's flow,
    HiFT and voice encoder calls are jitted (its engine code unchanged)."""
    from types import SimpleNamespace

    from audiolab_tpu.models import chatterbox_s3gen as JS
    from audiolab_tpu.pipelines import tts as JT
    from audiolab_tpu_torch.pipelines import tts as TT

    t3_cfg, _t, t3_p, t3_m = chatterbox_t3()
    fcfg, hcfg, _ft, fp, _ht, hp, s3 = s3gen()
    kw, tkw = {}, {}
    if encoders:
        _vt, ve_p, ve_m = voice_encoder()
        cp_cfg, _ct, cp_p, cp_m = campplus()
        st_cfg, _st, st_p, st_m = s3tokenizer()
        kw = dict(ve_params=ve_p, campplus_params=cp_p, campplus_cfg=cp_cfg,
                  s3tok_params=st_p, s3tok_cfg=st_cfg)
        tkw = dict(ve=ve_m, campplus=cp_m, s3tok=st_m)
    j = JT.ChatterboxCheckpointEngine(t3_cfg, t3_p, fcfg, fp, hcfg, hp, **kw)
    j.ve = Jitted(j.ve)
    j.s3gen.flow = SimpleNamespace(apply=jax.jit(JS.CausalMaskedDiffWithXvec(fcfg).apply))
    j.s3gen.hift = SimpleNamespace(apply=jax.jit(JS.HiFTGenerator(hcfg).apply))
    return j, TT.ChatterboxCheckpointEngine(t3_m, s3, device="cpu", **tkw)


@functools.lru_cache(maxsize=None)
def whisper_demo(seed: int = 52):
    """(JAX WhisperConfig, flax params, port WhisperModel) at the demo widths
    of ``random_transcriber`` on the same weights.  The decoder's final
    LayerNorm scale is negated: a random model's residual otherwise favours
    the token it was fed, and no timestamp pair comes out."""
    from audiolab_tpu.models import whisper as JW
    from audiolab_tpu_torch.models import whisper as TW
    from audiolab_tpu_torch.pipelines.transcribe import DEMO_CONFIG

    cfg = JW.WhisperConfig(**{k: getattr(DEMO_CONFIG, k) for k in (
        "n_mels", "dim", "n_heads", "n_audio_layers", "n_text_layers", "vocab_size",
        "n_text_ctx", "sot", "eot", "no_timestamps", "timestamp_base")})
    tpl = jax.eval_shape(lambda: JW.WhisperModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3000, cfg.n_mels)),
        jnp.zeros((1, 4), jnp.int32)))["params"]
    p = filled(tpl, seed)
    p["decoder"]["ln"]["scale"] = -p["decoder"]["ln"]["scale"]
    return cfg, p, _load(TW.WhisperModel(DEMO_CONFIG), W.whisper_from_jax(p))


def transcriber_pair(jax_kw: dict | None = None, port_kw: dict | None = None):
    """(JAX Transcriber, port Transcriber on the CPU) on ``whisper_demo``'s
    weights, with the engines' other arguments (aligner, vad, ...); the JAX
    engine's Whisper runs jitted (its engine code unchanged)."""
    from audiolab_tpu.pipelines import transcribe as JT
    from audiolab_tpu_torch.pipelines import transcribe as TT

    cfg, p, tm = whisper_demo()
    j = JT.Transcriber(cfg, p, **(jax_kw or {}))
    j.model = Jitted(j.model)
    return j, TT.Transcriber(tm, device="cpu", **(port_kw or {}))


# WaveGrad at test width: DBlock strides 2, 2, 3 and UBlock factors 5, 3, 2, 2
WAVEGRAD = dict(n_mels=16, hop=60, factors=(5, 3, 2, 2), ublock_ch=(16, 16, 8, 8),
                dblock_ch=(8, 8, 16), base_ch=4)


@functools.lru_cache(maxsize=None)
def wavegrad(seed: int = 60):
    """(JAX WaveGrad, flax template, flax params from :func:`filled`, port
    WaveGrad) at WAVEGRAD."""
    from audiolab_tpu.models import wavegrad as JWG
    from audiolab_tpu_torch.models import wavegrad as TWG

    jm = JWG.WaveGrad(JWG.WaveGradConfig(**WAVEGRAD))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 240)),
                                         jnp.zeros((1, 4, 16)), jnp.ones((1,))))["params"]
    p = filled(tpl, seed)
    return jm, tpl, p, _load(TWG.WaveGrad(TWG.WaveGradConfig(**WAVEGRAD)),
                             W.wavegrad_from_jax(p))


def jax_sample_draws(key, steps: int, b: int, n: int) -> np.ndarray:
    """The JAX ``sample``'s draws for ``key`` in the port's (steps + 1, b, n)
    layout: the start from ``key``, step i's noise from ``fold_in(key, i)``."""
    return np.stack([np.asarray(jax.random.normal(key, (b, n)))]
                    + [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (b, n)))
                       for i in range(steps)])


def jax_loss_draws(key, b: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX ``diffusion_loss``'s (noise level (b,), eps (b, n)) for ``key``."""
    from audiolab_tpu.models import wavegrad as JWG

    k1, k2 = jax.random.split(key)
    return (np.asarray(JWG.sample_noise_level(k1, b)),
            np.asarray(jax.random.normal(k2, (b, n))))


# the AudioSR stack at test width (GroupNorm's 32 groups bound the channels)
AUDIOSR_UNET = dict(in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
                    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32)
AUDIOSR_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
AUDIOSR_VOCODER = dict(num_mels=16, initial_channel=64, resblock_kernels=(3, 7),
                       resblock_dilations=((1, 3, 5),) * 2)


@functools.lru_cache(maxsize=None)
def audiosr(seed: int = 61):
    """{"unet" | "vae" | "vocoder": (JAX module, flax template, flax params,
    port module)} at the AUDIOSR_* widths."""
    from audiolab_tpu.models import audiosr_unet as JU
    from audiolab_tpu.models import audiosr_vae as JV
    from audiolab_tpu.models import audiosr_vocoder as JVo
    from audiolab_tpu_torch.models import audiosr_unet as TU
    from audiolab_tpu_torch.models import audiosr_vae as TV
    from audiolab_tpu_torch.models import audiosr_vocoder as TVo

    out = {}
    ju = JU.AudioSRUNet(JU.AudioSRUNetConfig(**AUDIOSR_UNET))
    tpl = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)),
                                         jnp.zeros((1,))))["params"]
    p = filled(tpl, seed)
    ucfg = TU.AudioSRUNetConfig(**AUDIOSR_UNET)
    out["unet"] = (ju, tpl, p, _load(TU.AudioSRUNet(ucfg), W.audiosr_unet_from_jax(p, ucfg)))
    jv = JV.AudioSRVAE(**AUDIOSR_VAE)
    tpl = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1))))["params"]
    p = filled(tpl, seed + 1)
    out["vae"] = (jv, tpl, p, _load(TV.AudioSRVAE(**AUDIOSR_VAE), W.audiosr_vae_from_jax(p)))
    jo = JVo.AudioSRVocoder(**AUDIOSR_VOCODER)
    tpl = jax.eval_shape(lambda: jo.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16))))["params"]
    p = filled(tpl, seed + 2)
    out["vocoder"] = (jo, tpl, p, _load(TVo.AudioSRVocoder(**AUDIOSR_VOCODER),
                                        W.audiosr_vocoder_from_jax(p)))
    return out
