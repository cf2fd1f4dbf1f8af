"""YuE two-stage LM music generation, vocals and accompaniment (counterpart
of audiolab_tpu/models/yue.py).

- Stage 1: a LLaMA-layout ``TransformerLM`` over the mm-v0.2 vocabulary
  generates interleaved (vocal, instrumental) xcodec codebook-0 tokens, one
  frame after another.  The prompt rows [cond; uncond] run as a batch of
  two; each step merges their logits by classifier-free guidance, applies
  the repetition penalty, the codebook range mask, temperature, top-k and
  nucleus top-p, draws ONE token by a Gumbel argmax and feeds it to both
  rows.  ``lm.decode`` samples per row, so stage 1 has its own step.
- Stage 2: a second ``TransformerLM`` upsamples codebook 0 to ``n_q``
  codebooks in blocks of ``stage2_block`` frames, all blocks as one batch:
  frame by frame, codebook 0 is teacher-forced and codebooks 1..n_q-1 are
  greedy within their own 1024-id slice.
- Both stages prefill through the static cache (plain attention under the
  left-pad key mask, as the JAX package computes it) and replay one decode
  step captured in a CUDA graph (``models/lm.py::replay``); YuE launches
  none of the hand-written kernels.
- The draws are explicit: stage 1's Gumbel draws for segment ``i`` are
  ``draws(seed + i, (2 * frames, 1, vocab))`` (``gumbel_draws`` without a
  ``draws``), so the tests can hand in the JAX keys' draws.
- Decode: xcodec (the checkpoint's path), else Vocos over the RVQ latents,
  else the SEANet decoder; the mix of vocals and accompaniment is scaled to
  a peak of 0.99.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.codecs import (
    CodecConfig,
    SEANetConfig,
    SoundStreamCodec,
    Vocos,
    VocosConfig,
    XCodecDecoder,
)
from audiolab_tpu_torch.models.lm import (
    LMConfig,
    StageTimer,
    TransformerLM,
    gumbel_draws,
    init_cache,
    model_device,
    replay,
    resolve_draws,
)
from audiolab_tpu_torch.utils.fast_init import fast_init

# ----------------------------------------------------------- vocabulary
#
# mm-tokenizer v0.2 layout (codecmanipulator.py:28-57; models/mm_vocab.py
# holds the full table and the SentencePiece wrapper): the text pieces, 22
# special tokens, the codec ranges; xcodec is 12 codebooks x 1024 from
# 45334.  Stage 1 emits interleaved vocal/instrumental codebook-0 tokens;
# stage 2 teacher-forces codebook 0 and emits codebooks 1..7 at
# xcodec_base + k * K.

# special-name -> index within the 22-token special block (mm_v0_2 order)
_SPECIAL_ORDER = (
    "eod", "soa", "eoa", "soi", "eoi", "sov", "eov", "s_local", "e_local",
    "s_global", "e_global", "semantic", "acoustic", "stage1", "dac_16k",
    "dac_44k", "xcodec", "stage2", "semantic_mert", "semantic_hubert",
    "visual", "semanticodec",
)


@dataclass(frozen=True)
class YuEVocab:
    """mm-v0.2-shaped vocabulary, parametric so tests can shrink it; the
    defaults are the published layout (xcodec_base 45334, size 83734)."""

    codebook_size: int = 1024
    text_size: int = 32000
    n_q_total: int = 12            # xcodec codebooks reserved in the vocab
    pre_xcodec_codebooks: int = 13  # dac16k 4 + dac44k 9 codebooks before xcodec
    post_xcodec_ids: int = 26112   # mert 1024 + hubert 512 + semanticodec 24576

    def special(self, name: str) -> int:
        return self.text_size + _SPECIAL_ORDER.index(name)

    @property
    def special_base(self) -> int:
        return self.text_size

    @property
    def xcodec_base(self) -> int:
        return (self.text_size + len(_SPECIAL_ORDER)
                + self.pre_xcodec_codebooks * self.codebook_size)

    def codebook_base(self, k: int) -> int:
        """LM-id base of xcodec codebook k (0..n_q_total-1)."""
        return self.xcodec_base + k * self.codebook_size

    # both stage-1 streams live in xcodec codebook 0 (interleaved)
    @property
    def vocal_base(self) -> int:
        return self.xcodec_base

    @property
    def inst_base(self) -> int:
        return self.xcodec_base

    @property
    def size(self) -> int:
        return (self.xcodec_base + self.n_q_total * self.codebook_size
                + self.post_xcodec_ids)


def encode_text(s: str, max_len: int = 512, text_size: int = 32000) -> np.ndarray:
    """Byte text encoder for tokenizer-less (test and random) runs; real
    checkpoints use ``mm_vocab.MMTokenizer`` through ``YuEPipeline(tokenizer=)``."""
    b = s.encode("utf-8")[:max_len]
    return np.frombuffer(b, np.uint8).astype(np.int32) % min(256, text_size)


@dataclass
class YuEConfig:
    vocab: YuEVocab = field(default_factory=YuEVocab)
    stage1: LMConfig = field(default_factory=lambda: LMConfig(
        vocab_size=YuEVocab().size, dim=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, ffn_dim=5632, max_seq_len=8192))
    # stage 2 shares the mm vocabulary
    stage2: LMConfig = field(default_factory=lambda: LMConfig(
        vocab_size=YuEVocab().size, dim=1024, n_layers=8,
        n_heads=16, n_kv_heads=16, ffn_dim=2816, max_seq_len=4096))
    stage2_block: int = 300
    n_q: int = 8


def _ids(x, dev: torch.device) -> torch.Tensor:
    """Token ids (a tensor anywhere, or an array) as int64 on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.int64))
    return x.to(dev, torch.long)


def block_token_range_processor(lo: int, hi: int):
    """A logit processor that keeps [lo, hi) and sets the rest to -inf."""

    def proc(logits: torch.Tensor, _i) -> torch.Tensor:
        ar = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where((ar >= lo) & (ar < hi), logits, -math.inf)

    return proc


# ------------------------------------------------------------------ stage 1

@torch.inference_mode()
def stage1_generate(
    lm: TransformerLM,
    prompt_tokens,                  # (2, t_prompt) [cond; uncond] rows
    frames: int,
    vocab: YuEVocab,
    cfg_scale: float = 1.5,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.93,
    repetition_penalty: float = 1.2,
    valid_from=None,                # (2,) first real position per row
    seed: int = 0,
    draws=None,
    graph: bool | None = None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Interleaved (vocal, instrumental) codebook-0 codes (2, frames).

    The prompt is left-padded with <EOA> to a multiple of 128 and the pads
    are kept out of attention by a key mask (positions before
    ``valid_from``), in the prefill and at every step.  Each step: the CFG
    merge uncond + s * (cond - uncond); the repetition penalty (divide a
    positive logit, multiply a negative one) over a presence set that starts
    from the conditional row's real prompt and takes every drawn token; the
    codebook range; division by max(temperature, 1e-6); top-k; top-p with
    the JAX rule cutoff = sorted[sum(cumsum(softmax(sorted)) < top_p)]; then
    the argmax of the logits plus the step's Gumbel draw.  ``draws``:
    (2 * frames, 1, vocab) draws, a callable of that shape, or None
    (``gumbel_draws`` from ``seed``).  ``graph``: capture one step and
    replay it (default on the card)."""
    dev, graph = model_device(lm, device, graph, "stage1_generate")
    mark = StageTimer(stats, dev)
    v_size = lm.cfg.vocab_size
    total = 2 * frames
    prompt = _ids(prompt_tokens, dev)
    b2, t_prompt = prompt.shape
    if b2 != 2:
        raise ValueError("stage1_generate: pass [cond; uncond] rows")
    vf = (np.zeros(2, np.int64) if valid_from is None
          else _ids(valid_from, torch.device("cpu")).numpy())
    bucket = -(-t_prompt // 128) * 128
    if bucket != t_prompt:
        pad = torch.full((2, bucket - t_prompt), vocab.special("eoa"), dtype=torch.long,
                         device=dev)
        prompt = torch.cat([pad, prompt], dim=1)
        vf = vf + (bucket - t_prompt)
    vf_t = torch.as_tensor(vf, device=dev)
    seq_len = bucket + total + 1
    key_valid = (torch.arange(seq_len, device=dev)[None, :] >= vf_t[:, None])[:, None, None, :]
    draws = resolve_draws(draws, (total, 1, v_size), seed, dev)
    caches = init_cache(lm.cfg, 2, seq_len, dev)
    logits, _ = lm(prompt, torch.arange(bucket, device=dev), caches, key_valid)
    last = logits[:, -1].float().contiguous()
    # the presence set over the conditional row's real prompt (pads go to a
    # scratch slot past the vocabulary)
    real = torch.where(torch.arange(bucket, device=dev) >= vf_t[0], prompt[0], v_size)
    seen = torch.zeros(v_size + 1, dtype=torch.bool, device=dev)
    seen[real] = True
    mark("prefill_s")

    ar = torch.arange(v_size, device=dev)
    bases = torch.tensor([vocab.vocal_base, vocab.inst_base], device=dev)
    pos = torch.full((1,), bucket, dtype=torch.long, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)
    out = torch.empty(total, dtype=torch.long, device=dev)
    tok2 = torch.empty((2, 1), dtype=torch.long, device=dev)
    temp = max(temperature, 1e-6)

    def step():
        lc, lu = last[0], last[1]
        lg = lu + cfg_scale * (lc - lu)
        if repetition_penalty != 1.0:
            pen = torch.where(lg > 0, lg / repetition_penalty, lg * repetition_penalty)
            lg = torch.where(seen[:v_size], pen, lg)
        lo = bases.index_select(0, i % 2)            # even step: vocal, odd: inst
        lg = torch.where((ar >= lo) & (ar < lo + vocab.codebook_size), lg, -math.inf)
        lg = lg / temp
        if top_k > 0:
            kth = torch.topk(lg, min(top_k, v_size)).values[-1]
            lg = torch.where(lg < kth, -math.inf, lg)
        if top_p > 0.0:
            srt = torch.sort(lg, descending=True).values
            cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            cut = (cum < top_p).sum().clamp(max=v_size - 1)
            lg = torch.where(lg < srt.gather(0, cut[None]), -math.inf, lg)
        tok = (lg + draws.index_select(0, i)[0, 0]).argmax()[None]
        seen.index_fill_(0, tok, True)
        out.index_copy_(0, i, tok)
        tok2.copy_(tok.expand(2, 1))
        logits, _ = lm(tok2, pos, caches, key_valid)
        last.copy_(logits[:, -1])
        pos.add_(1)
        i.add_(1)

    replay(step, total, dev, graph)
    mark("decode_s")
    mark.put("steps", total)
    pairs = out.reshape(frames, 2)
    return torch.stack([pairs[:, 0] - vocab.vocal_base, pairs[:, 1] - vocab.inst_base])


# ------------------------------------------------------------------ stage 2

@torch.inference_mode()
def stage2_generate(
    lm: TransformerLM,
    codes0,                         # (b, t) codebook-0 codes (one track a row)
    vocab: YuEVocab,
    n_q: int = 8,
    block: int = 300,
    graph: bool | None = None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Codebook 0 -> n_q codebooks (b, n_q, t) in blocks of ``block`` frames,
    padded to a power-of-two count of blocks and run as one batch.  Each
    block's prompt is [<SOA>, <stage_1>, cb0 x block, <stage_2>] under a key
    mask over the prompt; then per frame codebook 0 is teacher-forced and
    codebook j = 1..n_q-1 is the argmax within [max(lo_j, lo_1),
    min(lo_j + K, hi)).  The codes are the tokens less their codebook's
    offset (not clipped: the pipeline clips them)."""
    dev, graph = model_device(lm, device, graph, "stage2_generate")
    mark = StageTimer(stats, dev)
    codes0 = _ids(codes0, dev)
    b, t = codes0.shape
    pad = (-t) % block
    n_blocks = (t + pad) // block
    blocks = F.pad(codes0, (0, pad)).reshape(b * n_blocks, block)
    nb = blocks.shape[0]
    nb_bucket = 1 << max(nb - 1, 0).bit_length()
    blocks = F.pad(blocks, (0, 0, 0, nb_bucket - nb))
    mark.put("blocks", nb)
    mark.put("blocks_bucket", nb_bucket)

    K = vocab.codebook_size
    lo1, hi = vocab.codebook_base(1), vocab.codebook_base(n_q)
    prompt_len = block + 3
    total = block * n_q
    seq_len = prompt_len + total + 1
    cb0 = blocks + vocab.xcodec_base
    col = lambda tok: torch.full((nb_bucket, 1), tok, dtype=torch.long, device=dev)  # noqa: E731
    prompt = torch.cat([col(vocab.special("soa")), col(vocab.special("stage1")), cb0,
                        col(vocab.special("stage2"))], dim=1)
    caches = init_cache(lm.cfg, nb_bucket, seq_len, dev)
    mask = (torch.arange(seq_len, device=dev) < prompt_len)[None, None, None, :]
    logits, _ = lm(prompt, torch.arange(prompt_len, device=dev), caches, mask)
    last = logits[:, -1].float().contiguous()
    mark("prefill_s")

    ar = torch.arange(lm.cfg.vocab_size, device=dev)
    pos = torch.full((1,), prompt_len, dtype=torch.long, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)
    toks = torch.empty((total, nb_bucket), dtype=torch.long, device=dev)

    def step():
        j, f = i % n_q, i // n_q                      # j = 0: teacher-forced cb0
        lo_j = vocab.xcodec_base + j * K
        allowed = (ar >= torch.clamp(lo_j, min=lo1)) & (ar < torch.clamp(lo_j + K, max=hi))
        gen = torch.where(allowed[None, :], last, -math.inf).argmax(dim=-1)
        tok = torch.where(j == 0, cb0.index_select(1, f)[:, 0], gen)
        toks.index_copy_(0, i, tok[None])
        logits, _ = lm(tok[:, None], pos, caches)
        last.copy_(logits[:, -1])
        pos.add_(1)
        i.add_(1)

    replay(step, total, dev, graph)
    mark("decode_s")
    mark.put("steps", total)
    full = toks.t().reshape(nb_bucket, block, n_q).transpose(1, 2)
    offs = (vocab.xcodec_base + torch.arange(n_q, device=dev) * K)[None, :, None]
    full = (full - offs)[:nb].reshape(b, n_blocks, n_q, block)
    return full.transpose(1, 2).reshape(b, n_q, n_blocks * block)[:, :, :t]


# ------------------------------------------------------------------ pipeline

@dataclass
class YuEPipelineConfig:
    frame_rate: float = 50.0
    segment_frames: int = 512
    # the published generate arguments: CFG 1.5 on the first segment, then
    # 1.2; nucleus top_p 0.93; repetition penalty 1.2
    cfg_scale: float = 1.5
    cfg_scale_later: float = 1.2
    top_k: int = 0
    top_p: float = 0.93
    temperature: float = 1.0
    repetition_penalty: float = 1.2
    # "tail": the unconditional context is the prompt's last token (what
    # transformers' unbatched CFG does for the published run);
    # "lyrics_stripped": a genre-only unconditional context
    uncond_mode: str = "tail"


class YuEPipeline:
    """Lyrics segments -> stage 1 -> stage 2 -> codec decode -> the mix of
    vocals and accompaniment, on ``device``.  ``codec`` supplies the frame
    rate (and, without ``xcodec`` or ``vocos``, the SEANet decode; None is
    a ``CodecConfig()`` that decodes nothing).  ``draws(seed, shape)`` gives
    a segment's stage-1 Gumbel draws (default ``gumbel_draws`` on the
    device)."""

    def __init__(self, cfg: YuEConfig, s1: TransformerLM, s2: TransformerLM,
                 codec: SoundStreamCodec | None = None, vocos: Vocos | None = None,
                 pcfg: YuEPipelineConfig | None = None, xcodec: XCodecDecoder | None = None,
                 tokenizer=None, device: str | torch.device = "cuda", draws=None,
                 graph: bool | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        # mm_vocab.MMTokenizer with a real tokenizer.model; bytes otherwise
        self.tokenizer = tokenizer
        self.s1 = s1.to(self.device).eval()
        self.s2 = s2.to(self.device).eval()
        self.codec = None if codec is None else codec.to(self.device).eval()
        self.codec_cfg = CodecConfig() if codec is None else codec.cfg
        self.vocos = None if vocos is None else vocos.to(self.device).eval()
        self.xcodec = None if xcodec is None else xcodec.to(self.device).eval()
        self.pcfg = pcfg or YuEPipelineConfig()
        self.draws = draws
        self.graph = graph

    def _tok(self, s: str) -> np.ndarray:
        if self.tokenizer is not None:
            return np.asarray(self.tokenizer.tokenize(s), np.int32)
        return encode_text(s, text_size=self.cfg.vocab.text_size)

    def _prompt(self, genre: str, lyrics: str, audio_codes=None,
                full_lyrics: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Stage-1 rows [cond; uncond] (2, t) and their first real positions:
        the instruction, [Genre] and the full lyrics, an optional reference
        ([start_of_reference] <SOA> <xcodec> cb0 ids <EOA>
        [end_of_reference]), then [start_of_segment], the section's text and
        <SOA> <xcodec>; left-padded with <EOA>."""
        v = self.cfg.vocab
        head = ("Generate music from the given lyrics segment by segment."
                f"\n[Genre] {genre}\n{full_lyrics if full_lyrics is not None else lyrics}")
        soa, eoa, sep = v.special("soa"), v.special("eoa"), v.special("xcodec")
        ref: list[int] = []
        if audio_codes is not None:
            cb0 = _ids(audio_codes, torch.device("cpu")).numpy()[0] + v.xcodec_base
            ref = (self._tok("[start_of_reference]").tolist() + [soa, sep] + cb0.tolist()
                   + [eoa] + self._tok("[end_of_reference]").tolist())
        seg_open = self._tok("[start_of_segment]").tolist()
        cond = np.concatenate([self._tok(head), ref, seg_open, self._tok(lyrics),
                               [soa, sep]]).astype(np.int32)
        if self.pcfg.uncond_mode == "tail":
            uncond = cond[-1:]
        else:
            uncond = np.concatenate([
                self._tok("Generate music from the given lyrics segment by segment.\n"
                          f"[Genre] {genre}\n"), seg_open, [soa, sep]]).astype(np.int32)
        t = max(len(cond), len(uncond))
        rows = np.full((2, t), eoa, np.int32)
        rows[0, t - len(cond):] = cond
        rows[1, t - len(uncond):] = uncond
        return rows, np.asarray([t - len(cond), t - len(uncond)], np.int32)

    def _draws(self, seed: int):
        if self.draws is None:
            return lambda *shape: gumbel_draws(*shape, seed, self.device)
        return lambda *shape: self.draws(seed, shape)

    def decode(self, full: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Codes (b, n_q, t) -> (audio (b, n), rate): xcodec, else Vocos over
        the RVQ latents, else the SEANet decoder."""
        with torch.inference_mode():
            if self.xcodec is not None:
                xc = self.xcodec.cfg
                audio = self.xcodec(full[:, :xc.n_q].clamp(0, xc.codebook_size - 1))
                return audio, int(round(self.codec_cfg.frame_rate * xc.hop))
            if self.vocos is not None:
                audio = self.vocos(self.codec.rvq.decode(full))
                return audio, int(round(self.codec_cfg.frame_rate * self.vocos.cfg.hop))
            return self.codec.decode(full), self.codec_cfg.sr

    def generate_music(self, genre: str, lyrics: str, n_segments: int = 1,
                       seconds_per_segment: float | None = None, audio_prompt_codes=None,
                       seed: int = 0, stats: dict | None = None) -> dict:
        """Returns {"mix", "vocal", "inst", "sr"} (numpy fp32).  ``stats``
        (when given) gets each stage's seconds and step counts."""
        p = self.pcfg
        frames = (p.segment_frames if seconds_per_segment is None
                  else int(seconds_per_segment * p.frame_rate))
        segments = [s.strip() for s in lyrics.split("\n\n") if s.strip()]
        segments = (segments or [lyrics])[:n_segments]
        while len(segments) < n_segments:
            segments.append(segments[-1])
        full_lyrics = "\n".join(segments)
        codes = []
        for i, seg in enumerate(segments):
            prompt, valid_from = self._prompt(
                genre, seg, audio_prompt_codes if i == 0 else None, full_lyrics=full_lyrics)
            s1 = None if stats is None else {}
            codes.append(stage1_generate(
                self.s1, prompt, frames, self.cfg.vocab,
                cfg_scale=p.cfg_scale if i == 0 else p.cfg_scale_later,
                temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
                repetition_penalty=p.repetition_penalty, valid_from=valid_from,
                draws=self._draws(seed + i), graph=self.graph, stats=s1,
                device=self.device))
            if stats is not None:
                stats.setdefault("stage1", []).append(s1)
        both0 = torch.cat(codes, dim=1)                     # (2, T): vocal, inst
        s2 = None if stats is None else {}
        full = stage2_generate(self.s2, both0, self.cfg.vocab, n_q=self.cfg.n_q,
                               block=self.cfg.stage2_block, graph=self.graph, stats=s2,
                               device=self.device)
        full = full.clamp(0, self.cfg.vocab.codebook_size - 1)
        mark = StageTimer(stats, self.device)
        audio, sr = self.decode(full)
        mark("decode_s")
        if stats is not None:
            stats["stage2"] = s2
            stats["codes"] = full.cpu()
        audio = audio.float().cpu().numpy()
        vocal, inst = audio[0], audio[1]
        mix = vocal + inst
        peak = np.abs(mix).max() + 1e-9
        if peak > 0.99:
            mix = mix * (0.99 / peak)
        return {"mix": mix, "vocal": vocal, "inst": inst, "sr": sr}

    # the music routes' backend protocol: (samples, sr)
    def generate(self, prompt: str, lyrics: str = "", n_segments: int = 1, **kw):
        out = self.generate_music(prompt, lyrics or prompt, n_segments=n_segments, **kw)
        return out["mix"], out["sr"]


def random_yue(seed: int = 0, with_vocos: bool = False,
               device: str | torch.device = "cuda") -> YuEPipeline:
    """Tiny random-weight pipeline on ``device`` (the JAX package's demo
    widths: a shrunken mm-v0.2 layout, two 2-layer LMs, a SEANet codec;
    weights by utils/fast_init's rules from ``seed``)."""
    dev = resolve_device(device)
    vocab = YuEVocab(codebook_size=32, text_size=64, pre_xcodec_codebooks=2,
                     n_q_total=8, post_xcodec_ids=16)
    cfg = YuEConfig(
        vocab=vocab,
        stage1=LMConfig(vocab_size=vocab.size, dim=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=64, max_seq_len=2048, dtype="float32"),
        stage2=LMConfig(vocab_size=vocab.size, dim=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=64, max_seq_len=4096, dtype="float32"),
        stage2_block=8,
        n_q=4,
    )
    ccfg = CodecConfig(sr=16000, seanet=SEANetConfig(dim=32, n_filters=4, ratios=(4, 2),
                                                     n_res=1),
                       n_q=4, codebook_size=32)
    with dev:
        s1 = fast_init(TransformerLM(cfg.stage1), seed)
        s2 = fast_init(TransformerLM(cfg.stage2), seed + 1)
        codec = fast_init(SoundStreamCodec(ccfg), seed + 2)
        vocos = None
        if with_vocos:
            vocos = fast_init(Vocos(VocosConfig(dim=32, n_layers=1, n_fft=64, hop=16),
                                    in_dim=ccfg.seanet.dim), seed + 3)
    return YuEPipeline(cfg, s1, s2, codec, vocos=vocos,
                       pcfg=YuEPipelineConfig(segment_frames=16), device=dev)
