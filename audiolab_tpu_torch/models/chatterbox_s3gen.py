"""Chatterbox S3Gen: speech tokens -> 24 kHz waveform (counterpart of
audiolab_tpu/models/chatterbox_s3gen.py), under the names of the published
``s3gen.safetensors`` (``flow.*`` and ``mel2wav.*``), the names
``convert_s3gen_flow`` / ``convert_hift`` map.

  flow      CausalMaskedDiffWithXvec: token embedding, the x-vector's
            Linear(192 -> 80), UpsampleConformerEncoder (rel-pos conformer
            layers, 2x nearest upsample, more layers; 25 Hz tokens -> 50 Hz
            frames), encoder_proj, and CausalConditionalCFM: an Euler ODE
            over the causal UNet estimator (ConditionalDecoder) with CFG
            rate 0.7 and the cosine t-schedule, from a fixed noise
  mel2wav   HiFTGenerator: the NSF harmonic source, three transposed-conv
            upsamplings with source fusion and Snake resblocks, and the
            iSTFT head (n_fft 16, hop 4)

Every attention here (the conformer's rel-pos attention, the estimator's
transformer blocks) is plain PyTorch ops, as in the JAX package.  The flow
works on (b, t, c) and convolves through transposes; HiFT on (b, c, t).

Randomness: the CFM noise is the JAX package's fixed
``np.random.default_rng(0).standard_normal((1, 15000, mel_dim))``, a buffer
of :class:`S3Token2Wav`.  HiFT's source draws (the uniform initial phases
and the normal noise) are passed in (``source_draws``) or drawn from a
``torch.Generator`` seeded with ``seed`` on the model's device; the JAX
package draws them from ``PRNGKey(seed)`` and ``fold_in(., 1)``.  The
source's phase is a running sum over every sample; it is summed in fp64
so that the card and the CPU round it alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.kernels.stft import istft, stft
from audiolab_tpu_torch.models.codecs import snake
from audiolab_tpu_torch.models.layers import get_padding
from audiolab_tpu_torch.models.lm import StageTimer


# ---------------------------------------------------------------- configs

@dataclass(frozen=True)
class FlowConfig:
    token_vocab: int = 6561
    dim: int = 512
    mel_dim: int = 80
    xvector_dim: int = 192
    heads: int = 8
    ffn_dim: int = 2048
    n_layers: int = 6
    n_up_layers: int = 4
    pre_lookahead: int = 3
    token_mel_ratio: int = 2
    # estimator (ConditionalDecoder)
    est_channels: int = 256
    est_mid_blocks: int = 12
    est_n_blocks: int = 4
    est_heads: int = 8
    est_head_dim: int = 64
    n_timesteps: int = 10
    cfg_rate: float = 0.7
    sigma_min: float = 1e-6

    @property
    def est_in_channels(self) -> int:
        return 4 * self.mel_dim  # [x | mu | spks | cond]


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple = (8, 5, 3)
    upsample_kernel_sizes: tuple = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: tuple = (7, 7, 11)
    source_resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        out = self.istft_hop
        for r in self.upsample_rates:
            out *= r
        return out


def _conv_ntc(conv: nn.Conv1d, x: torch.Tensor, left: int = 0, right: int = 0) -> torch.Tensor:
    """``conv`` over (b, t, c), zero-padded by ``left`` / ``right`` in time."""
    y = x.transpose(1, 2)
    if left or right:
        y = F.pad(y, (left, right))
    return conv(y).transpose(1, 2)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# ------------------------------------------------ conformer flow encoder

def espnet_rel_pos_emb(t: int, dim: int) -> np.ndarray:
    """ESPnet relative positional encoding over positions t-1 .. -(t-1):
    (1, 2t-1, dim) float32."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float32)
    inv = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    ang = pos[:, None] * inv[None, :]
    pe = np.zeros((2 * t - 1, dim), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe[None]


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(b, h, t, 2t-1) relative logits -> (b, h, t, t): column m of the input
    is relative position t-1-m, out[i, j] = x[i, t-1-i+j] (the pad-and-
    reshape skew of wenet/espnet)."""
    b, h, t, _ = x.shape
    y = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return y[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(nn.Module):
    """ESPnet RelPositionMultiHeadedAttention: content and position scores
    with pos_bias_u / pos_bias_v and the rel-shift skew."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        d = dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d))

    def forward(self, x, pos_emb):
        h, d = self.heads, self.dim // self.heads
        b, t, _ = x.shape
        q = self.linear_q(x).reshape(b, t, h, d)
        k = self.linear_k(x).reshape(b, t, h, d)
        v = self.linear_v(x).reshape(b, t, h, d)
        p = self.linear_pos(pos_emb).reshape(1, -1, h, d)
        qk = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u, k)
        qp = rel_shift(torch.einsum("bthd,xmhd->bhtm", q + self.pos_bias_v, p))
        probs = torch.softmax((qk + qp) / math.sqrt(d), dim=-1)
        o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, self.dim)
        return self.linear_out(o)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, ffn_dim)
        self.w_2 = nn.Linear(ffn_dim, dim)

    def forward(self, x):
        return self.w_2(F.silu(self.w_1(x)))


class ConformerLayer(nn.Module):
    """normalize_before conformer layer without macaron or conv modules."""

    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.norm_mha = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = RelPosSelfAttention(dim, heads)
        self.norm_ff = nn.LayerNorm(dim, eps=1e-5)
        self.feed_forward = _FeedForward(dim, ffn_dim)

    def forward(self, x, pos_emb):
        x = x + self.self_attn(self.norm_mha(x), pos_emb)
        return x + self.feed_forward(self.norm_ff(x))


class LinearEmbed(nn.Module):
    """wenet LinearNoSubsampling (Linear + LayerNorm as ``out``), scaled by
    sqrt(dim) as the rel-pos encoding does."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.dim = dim
        self.out = nn.Sequential(nn.Linear(cin, dim), nn.LayerNorm(dim, eps=1e-5))

    def forward(self, x):
        return self.out(x) * math.sqrt(self.dim)


class PreLookaheadLayer(nn.Module):
    """conv1 looks ``pre_lookahead`` frames ahead, conv2 is causal; residual."""

    def __init__(self, dim: int, pre_lookahead: int = 3):
        super().__init__()
        self.pre_lookahead = pre_lookahead
        self.conv1 = nn.Conv1d(dim, dim, pre_lookahead + 1)
        self.conv2 = nn.Conv1d(dim, dim, 3)

    def forward(self, x):
        y = F.leaky_relu(_conv_ntc(self.conv1, x, right=self.pre_lookahead), 0.01)
        return x + _conv_ntc(self.conv2, y, left=2)


class Upsample1D(nn.Module):
    """2x nearest upsample + a left-padded conv (kernel 2 * stride + 1)."""

    def __init__(self, dim: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(dim, dim, 2 * stride + 1)

    def forward(self, x):
        return _conv_ntc(self.conv, x.repeat_interleave(self.stride, dim=1),
                         left=2 * self.stride)


class UpsampleConformerEncoder(nn.Module):
    def __init__(self, cfg: FlowConfig):
        super().__init__()
        c = cfg
        self.dim = c.dim
        self.embed = LinearEmbed(c.dim, c.dim)
        self.pre_lookahead_layer = PreLookaheadLayer(c.dim, c.pre_lookahead)
        self.encoders = nn.ModuleList(ConformerLayer(c.dim, c.heads, c.ffn_dim)
                                      for _ in range(c.n_layers))
        self.up_layer = Upsample1D(c.dim, 2)
        self.up_embed = LinearEmbed(c.dim, c.dim)
        self.up_encoders = nn.ModuleList(ConformerLayer(c.dim, c.heads, c.ffn_dim)
                                         for _ in range(c.n_up_layers))
        self.after_norm = nn.LayerNorm(c.dim, eps=1e-5)

    def _pos(self, x):
        return torch.tensor(espnet_rel_pos_emb(x.shape[1], self.dim), device=x.device)

    def forward(self, x):
        x = self.pre_lookahead_layer(self.embed(x))
        pos = self._pos(x)
        for layer in self.encoders:
            x = layer(x, pos)
        x = self.up_embed(self.up_layer(x))
        pos = self._pos(x)
        for layer in self.up_encoders:
            x = layer(x, pos)
        return self.after_norm(x)


# --------------------------------------------------- CFM estimator (UNet)

class CausalConv1d(nn.Conv1d):
    """A left-padded conv over (b, t, c): causal in time."""

    def forward(self, x):
        return _conv_ntc(super().forward, x, left=self.kernel_size[0] - 1)


class _Transpose(nn.Module):
    """The Transpose(1, 2) slots of the checkpoint's Sequential (no weights)."""

    def forward(self, x):
        return x


class _Mish(nn.Module):
    def forward(self, x):
        return _mish(x)


class CausalBlock1D(nn.Module):
    """CausalConv1d(3) + LayerNorm over channels + Mish, as
    ``block.{0,1,2,3,4}`` (the conv at 0, the norm at 2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(CausalConv1d(cin, cout, 3), _Transpose(),
                                   nn.LayerNorm(cout, eps=1e-5), _Transpose(), _Mish())

    def forward(self, x):
        return self.block(x)


class CausalResnetBlock1D(nn.Module):
    """block1 -> + time MLP -> block2, residual through a 1x1 conv."""

    def __init__(self, cin: int, cout: int, time_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(_Mish(), nn.Linear(time_dim, cout))
        self.block1 = CausalBlock1D(cin, cout)
        self.block2 = CausalBlock1D(cout, cout)
        self.res_conv = nn.Conv1d(cin, cout, 1)

    def forward(self, x, t_emb):
        h = self.block1(x) + self.mlp(t_emb)[:, None, :]
        return self.block2(h) + _conv_ntc(self.res_conv, x)


class _EstAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x):
        b, t, _ = x.shape
        h, hd = self.heads, self.head_dim
        q = self.to_q(x).reshape(b, t, h, hd).transpose(1, 2)
        k = self.to_k(x).reshape(b, t, h, hd).transpose(1, 2)
        v = self.to_v(x).reshape(b, t, h, hd).transpose(1, 2)
        a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v).transpose(1, 2)
        return self.to_out(o.reshape(b, t, h * hd))


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))


class EstTransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock (self-attention, exact-GELU FF): the
    attention's inner width is heads x head_dim, not the block's."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = _EstAttention(dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([_GELUProj(dim, 4 * dim), nn.Identity(),
                                     nn.Linear(4 * dim, dim)])

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        net = self.ff.net
        return x + net[2](net[0](self.norm3(x)))


class ConditionalDecoder(nn.Module):
    """matcha-style causal UNet velocity estimator: one down level, the mid
    resnet + transformer pairs, one up level with the skip."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = c = cfg
        ch, tdim = c.est_channels, 4 * c.est_channels

        def tbs():
            return nn.ModuleList(EstTransformerBlock(ch, c.est_heads, c.est_head_dim)
                                 for _ in range(c.est_n_blocks))

        self.time_mlp = nn.Module()
        self.time_mlp.linear_1 = nn.Linear(c.est_in_channels, tdim)
        self.time_mlp.linear_2 = nn.Linear(tdim, tdim)
        self.down_blocks = nn.ModuleList([nn.ModuleList([
            CausalResnetBlock1D(c.est_in_channels, ch, tdim), tbs(),
            CausalConv1d(ch, ch, 3)])])
        self.mid_blocks = nn.ModuleList(nn.ModuleList([CausalResnetBlock1D(ch, ch, tdim), tbs()])
                                        for _ in range(c.est_mid_blocks))
        self.up_blocks = nn.ModuleList([nn.ModuleList([
            CausalResnetBlock1D(2 * ch, ch, tdim), tbs(), CausalConv1d(ch, ch, 3)])])
        self.final_block = CausalBlock1D(ch, ch)
        self.final_proj = nn.Conv1d(ch, c.mel_dim, 1)
        half = c.est_in_channels // 2
        self.register_buffer("freqs", torch.tensor(np.exp(
            np.arange(half, dtype=np.float32) * np.float32(-(math.log(10000.0) / (half - 1))))),
            persistent=False)

    def forward(self, x, mu, spks, cond, t):
        """x, mu, cond (b, T, mel); spks (b, mel); t (b,) -> velocity (b, T, mel)."""
        ang = 1000.0 * t[:, None] * self.freqs[None]
        t_emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        t_emb = self.time_mlp.linear_2(F.silu(self.time_mlp.linear_1(t_emb)))
        h = torch.cat([x, mu, spks[:, None, :].expand(-1, x.shape[1], -1), cond], dim=-1)
        resnet, blocks, down = self.down_blocks[0]
        h = resnet(h, t_emb)
        for block in blocks:
            h = block(h)
        skip = h
        h = down(h)
        for resnet, blocks in self.mid_blocks:
            h = resnet(h, t_emb)
            for block in blocks:
                h = block(h)
        resnet, blocks, up = self.up_blocks[0]
        h = resnet(torch.cat([h, skip], dim=-1), t_emb)
        for block in blocks:
            h = block(h)
        h = self.final_block(up(h))
        return _conv_ntc(self.final_proj, h)


def cfm_times(steps: int) -> np.ndarray:
    """The cosine-warped t grid 1 - cos(pi t / 2) at steps + 1 points, in
    float32 as the JAX package computes it (on the CPU, whose fp32 cosine
    rounds as XLA's does)."""
    # jnp.linspace's iota / div, which XLA computes as iota * (1 / div)
    lin = torch.arange(steps + 1, dtype=torch.float32) * np.float32(1.0 / steps)
    lin[-1] = 1.0
    return (1.0 - torch.cos(lin * np.float32(math.pi / 2))).numpy()


class CausalConditionalCFM(nn.Module):
    """Euler ODE over the estimator with CFG: each step the conditional and
    the unconditional (mu, spks and cond zeroed) velocities as two
    estimator calls, merged as (1 + r) v_c - r v_u."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        self.estimator = ConditionalDecoder(cfg)

    def forward(self, mu, spks, cond, noise, n_timesteps: int | None = None):
        c = self.cfg
        ts = cfm_times(n_timesteps or c.n_timesteps)
        x = noise
        zeros = (torch.zeros_like(mu), torch.zeros_like(spks), torch.zeros_like(cond))
        for i in range(len(ts) - 1):
            t = torch.full((x.shape[0],), float(ts[i]), device=x.device)
            dt = float(np.float32(ts[i + 1] - ts[i]))
            v_c = self.estimator(x, mu, spks, cond, t)
            v_u = self.estimator(x, *zeros, t)
            x = x + dt * ((1.0 + c.cfg_rate) * v_c - c.cfg_rate * v_u)
        return x


class CausalMaskedDiffWithXvec(nn.Module):
    """Tokens + x-vector + prompt mel -> mel (b, T, mel_dim)."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = c = cfg
        self.input_embedding = nn.Embedding(c.token_vocab, c.dim)
        self.spk_embed_affine_layer = nn.Linear(c.xvector_dim, c.mel_dim)
        self.encoder = UpsampleConformerEncoder(c)
        self.encoder_proj = nn.Linear(c.dim, c.mel_dim)
        self.decoder = CausalConditionalCFM(c)

    def forward(self, tokens, xvector, prompt_mel, noise, n_timesteps: int | None = None):
        """tokens (b, s) [prompt tokens ++ generated]; xvector (b, xvector_dim);
        prompt_mel (b, t_prompt, mel) or None conditions the start; noise
        (b, s * ratio, mel).  Returns the whole mel (callers cut the
        prompt's frames off)."""
        c = self.cfg
        spk = xvector / torch.clamp(torch.linalg.norm(xvector, dim=-1, keepdim=True), min=1e-8)
        spk = self.spk_embed_affine_layer(spk)
        h = self.encoder(self.input_embedding(torch.clamp(tokens, 0, c.token_vocab - 1)))
        mu = self.encoder_proj(h)
        cond = torch.zeros_like(mu)
        if prompt_mel is not None and prompt_mel.shape[1]:
            cond[:, :prompt_mel.shape[1]] = prompt_mel
        return self.decoder(mu, spk, cond, noise, n_timesteps)


# ----------------------------------------------------------------- HiFT

class _Snake(nn.Module):
    """Snake with a per-channel ``alpha`` (channels,) over (b, c, t)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return snake(x, self.alpha[None, :, None])


class HiFTResBlock(nn.Module):
    """Snake-activated dilated convs1 / convs2 pairs with residuals."""

    def __init__(self, channels: int, kernel: int, dilations: tuple):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel, dilation=d,
                                              padding=get_padding(kernel, d))
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel,
                                              padding=get_padding(kernel, 1))
                                    for _ in dilations)
        self.activations1 = nn.ModuleList(_Snake(channels) for _ in dilations)
        self.activations2 = nn.ModuleList(_Snake(channels) for _ in dilations)

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations1,
                                  self.activations2):
            x = x + c2(a2(c1(a1(x))))
        return x


class ConvRNNF0Predictor(nn.Module):
    """Five convs with ELU (``condnet.{0,2,4,6,8}``), a linear classifier, |.|."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [nn.Conv1d(in_channels if i == 0 else cond_channels, cond_channels, 3,
                                 padding=1), nn.ELU()]
        self.condnet = nn.Sequential(*layers)
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel):
        """(b, c, t) -> f0 (b, t)."""
        x = self.condnet(mel).transpose(1, 2)
        return torch.abs(self.classifier(x)[..., 0])


class HiFTGenerator(nn.Module):
    """mel (b, t, in_channels) -> waveform (b, t * total_upsample)."""

    def __init__(self, cfg: HiFTConfig = HiFTConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.f0_predictor = ConvRNNF0Predictor(c.in_channels, c.f0_cond_channels)
        self.m_source = nn.Module()
        self.m_source.l_linear = nn.Linear(c.nb_harmonics + 1, 1)
        self.conv_pre = nn.Conv1d(c.in_channels, c.base_channels, 7, padding=3)
        n_src = c.istft_n_fft + 2
        # source-frame rate relative to x after the i-th upsample: the product
        # of the remaining rates (15, 3, 1 for (8, 5, 3))
        downs = [int(np.prod(c.upsample_rates[i + 1:])) for i in range(len(c.upsample_rates))]
        ups, source_downs, source_res, res = [], [], [], []
        ch = c.base_channels
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u, padding=(k - u) // 2))
            ch //= 2
            if downs[i] == 1:
                source_downs.append(nn.Conv1d(n_src, ch, 1))
            else:
                source_downs.append(nn.Conv1d(n_src, ch, 2 * downs[i], stride=downs[i],
                                              padding=downs[i] // 2))
            source_res.append(HiFTResBlock(ch, c.source_resblock_kernel_sizes[i],
                                           tuple(c.source_resblock_dilations[i])))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilations):
                res.append(HiFTResBlock(ch, rk, tuple(rd)))
        self.ups = nn.ModuleList(ups)
        self.source_downs = nn.ModuleList(source_downs)
        self.source_resblocks = nn.ModuleList(source_res)
        self.resblocks = nn.ModuleList(res)
        self.conv_post = nn.Conv1d(ch, c.istft_n_fft + 2, 7, padding=3)

    def source_draws(self, b: int, n: int, seed: int, device) -> tuple[torch.Tensor, ...]:
        """(uniform initial phases (b, 1, H), standard normals (b, n, H)) from a
        generator seeded with ``seed`` on ``device``; H = nb_harmonics + 1."""
        h = self.cfg.nb_harmonics + 1
        gen = torch.Generator(device=device).manual_seed(seed)
        return (torch.rand((b, 1, h), generator=gen, device=device),
                torch.randn((b, n, h), generator=gen, device=device))

    def nsf_source(self, f0_frames, draws):
        """f0 per mel frame (b, t) -> the harmonic-mixed source (b, t * up)
        (SourceModuleHnNSF + SineGen)."""
        c = self.cfg
        k_ini, normal = draws
        f0 = f0_frames.repeat_interleave(c.total_upsample, dim=1)          # (b, n)
        harmonics = torch.arange(1, c.nb_harmonics + 2, dtype=torch.float32, device=f0.device)
        rad = (f0[:, :, None] * harmonics) / c.sampling_rate
        k_ini = k_ini.clone()
        k_ini[:, :, 0] = 0.0        # SineGen zeroes the fundamental's initial phase
        cum = torch.cumsum(torch.remainder(rad, 1.0).double(), dim=1).float()
        phase = 2 * math.pi * (cum + k_ini)
        uv = (f0 > c.nsf_voiced_threshold).float()[:, :, None]
        noise_amp = uv * c.nsf_sigma + (1 - uv) * c.nsf_alpha / 3
        sines = uv * torch.sin(phase) * c.nsf_alpha + noise_amp * normal
        return torch.tanh(self.m_source.l_linear(sines))[..., 0]

    def source_stft(self, source):
        """(b, n) source -> (b, n_fft + 2, frames) [real | imag]."""
        c = self.cfg
        r, i = stft(source, n_fft=c.istft_n_fft, hop=c.istft_hop, win_length=c.istft_n_fft,
                    window="hann", center=True)
        return torch.cat([r, i], dim=-1).transpose(1, 2)

    def decode(self, mel, s_stft):
        """mel (b, t, c), source spectrum (b, n_fft + 2, frames) -> (b, n)."""
        c = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))
        n = len(c.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, 0.1))
            if i == len(self.ups) - 1:
                x = F.pad(x, (1, 0), mode="reflect")
            si = self.source_resblocks[i](self.source_downs[i](s_stft))
            # stride and padding rounding can leave si a frame long or short
            si = si[..., :x.shape[-1]]
            if si.shape[-1] < x.shape[-1]:
                si = F.pad(si, (0, x.shape[-1] - si.shape[-1]))
            x = x + si
            xs = 0.0
            for j in range(n):
                xs = xs + self.resblocks[i * n + j](x)
            x = xs / n
        x = self.conv_post(F.leaky_relu(x, 0.01)).transpose(1, 2)
        nb = c.istft_n_fft // 2 + 1
        magnitude = torch.exp(x[..., :nb])
        phase = torch.sin(x[..., nb:])     # upstream: sin, then the cos/sin split
        wav = istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                    n_fft=c.istft_n_fft, hop=c.istft_hop, win_length=c.istft_n_fft,
                    window="hann", center=True)
        return torch.clamp(wav, -c.audio_limit, c.audio_limit)

    def forward(self, mel, seed: int = 0, source_draws=None):
        """mel (b, t, in_channels) -> (b, t * total_upsample).  ``source_draws``:
        (uniform (b, 1, H), normal (b, n, H)); by default
        :meth:`source_draws` from ``seed``."""
        f0 = self.f0_predictor(mel.transpose(1, 2))
        if source_draws is None:
            source_draws = self.source_draws(mel.shape[0], mel.shape[1] * self.cfg.total_upsample,
                                             seed, mel.device)
        source = self.nsf_source(f0, tuple(
            (d if torch.is_tensor(d) else torch.from_numpy(np.array(d, np.float32))).to(
                mel.device, torch.float32) for d in source_draws))
        return self.decode(mel, self.source_stft(source))


def s3gen_ref_mel(wav24k: torch.Tensor) -> torch.Tensor:
    """The flow's prompt mel (matcha mel_spectrogram: 24 kHz, n_fft 1920, hop
    480, win 1920, 80 slaney mels 0 .. 8 kHz, (n_fft - hop) / 2 reflect pad,
    center off, log clamp 1e-5): (b, n) -> (b, t, 80)."""
    pad = (1920 - 480) // 2
    x = F.pad(wav24k.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    mel = mel_spectrogram(x, sr=24000, n_fft=1920, hop=480, win_length=1920, n_mels=80,
                          fmin=0.0, fmax=8000.0, htk=False, norm="slaney", power=1.0,
                          center=False)
    return log_mel(mel)


# ------------------------------------------------------------- assembly

class S3Token2Wav(nn.Module):
    """``flow`` + ``mel2wav`` with the fixed CFM noise (a buffer, not a
    weight: it moves with the module)."""

    def __init__(self, flow_cfg: FlowConfig = FlowConfig(), hift_cfg: HiFTConfig = HiFTConfig(),
                 rand_noise: np.ndarray | None = None):
        super().__init__()
        self.flow_cfg, self.hift_cfg = flow_cfg, hift_cfg
        self.flow = CausalMaskedDiffWithXvec(flow_cfg)
        self.mel2wav = HiFTGenerator(hift_cfg)
        # flow_matching.py: rand_noise = randn(1, 80, 50 * 300), sliced per utterance
        noise = (np.asarray(rand_noise, np.float32) if rand_noise is not None
                 else np.random.default_rng(0).standard_normal(
                     (1, 15000, flow_cfg.mel_dim)).astype(np.float32))
        self.register_buffer("rand_noise", torch.tensor(noise), persistent=False)

    @torch.inference_mode()
    def tokens_to_wav(self, tokens, xvector, prompt_mel=None, seed: int = 0, source_draws=None,
                      stats: dict | None = None) -> torch.Tensor:
        """tokens (b, s) [prompt tokens ++ generated], xvector (b, xvector_dim),
        prompt_mel (b, t_prompt, mel) or None -> (b, n) at 24 kHz; ``stats``
        gets the flow's and HiFT's seconds."""
        dev = self.rand_noise.device
        mark = StageTimer(stats, dev)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        xvector = torch.as_tensor(xvector, dtype=torch.float32, device=dev)
        if prompt_mel is not None:
            prompt_mel = torch.as_tensor(prompt_mel, dtype=torch.float32, device=dev)
        t_mel = tokens.shape[1] * self.flow_cfg.token_mel_ratio
        noise = self.rand_noise[:, :t_mel].expand(tokens.shape[0], -1, -1)
        mel = self.flow(tokens, xvector, prompt_mel, noise)
        if prompt_mel is not None:
            mel = mel[:, prompt_mel.shape[1]:]
        mark("flow_s")
        wav = self.mel2wav(mel, seed=seed, source_draws=source_draws)
        mark("hift_s")
        return wav
