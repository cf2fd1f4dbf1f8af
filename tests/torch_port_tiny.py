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
import torch

from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import rmvpe as JRm
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.utils.convert import convert_hubert, convert_rmvpe, convert_rvc
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import rmvpe as TRm
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.utils import weights as W

HCFG = dict(dim=32, ffn_dim=64, heads=4, layers=2, final_dim=16)
RM_SIZES = dict(en_de_layers=2, inter_layers=1, n_blocks=1, en_out_channels=4, gru_hidden=8)
SYNTH = dict(spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
             spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)


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
