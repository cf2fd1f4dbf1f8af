"""Plain reference of the separate -> convert chain, fp32 with TF32 off:
two BS-RoFormer members over 8 s chunks with 0.5 s crossfades, the
avg/median blend at the members' weights and the de-bleed, the mono mix
resampled to 16 kHz, and RVC v2-48k's conversion (48 Hz high-pass, 8 s
chunks with 0.4 s crossfades, HuBERT layer 12, exact 8-NN retrieval blend at
``index_rate``, RMVPE's salience decoded to f0, the consonant protection,
the synthesizer with the noise of one seeded generator per group of
chunks, peak normalisation).

It imports nothing of the program.  It builds its modules from the
configuration's file and fills them from the run's seed by the same names
and rules as the program's (``benchmark/weights.py``); the retrieval rows
are an input the benchmark made and hands to both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import dsp, hubert, precision, rmvpe, roformer, vits


def seeds(seed: int) -> dict:
    """The sub-seeds of each module's weights, shared with the program's
    side."""
    return {"members": [weights.subseed(seed, 10, i) for i in range(2)],
            "hubert": weights.subseed(seed, 11), "rmvpe": weights.subseed(seed, 12),
            "synth": weights.subseed(seed, 13), "index": weights.subseed(seed, 14)}


def roformer_config(sep: dict) -> roformer.Config:
    return roformer.Config(dim=sep["dim"], depth=sep["depth"], heads=sep["heads"],
                           dim_head=sep["dim_head"], stems=tuple(sep["stems"]),
                           residual_stem=sep["residual_stem"],
                           freqs_per_bands=tuple(sep["freqs_per_bands"]), n_fft=sep["n_fft"],
                           hop=sep["hop"], channels=sep["channels"], ff_mult=sep["ff_mult"],
                           mask_est_depth=sep["mask_est_depth"])


def synth_config(conv: dict) -> vits.Config:
    s = conv["synthesizer"]
    return vits.Config(**{k: (tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                              else tuple(v) if isinstance(v, list) else v)
                          for k, v in s.items()})


def index_rows(cfg: dict, seed: int, dev, hub=None) -> torch.Tensor:
    """The voice's retrieval rows, as RVC builds them: HuBERT features of
    the voice's training audio (``cfg["index"]``: seeded sung lines at 16
    kHz, in pieces of ``piece_frames`` frames), fp32."""
    from benchmark import generator

    ix = cfg["index"]
    s = seeds(seed)
    if hub is None:
        hub = weights.fill(hubert.Hubert(**cfg["converter"]["hubert"]).to(dev), s["hubert"],
                           cfg.get("init", {}).get("hubert"))
    n = (ix["piece_frames"] - 1) * 320 + 400
    pieces = ix["rows"] // ix["piece_frames"]
    gen = torch.Generator(device=dev).manual_seed(s["index"])
    rows = []
    with torch.inference_mode(), precision.fp32_flags():
        for start in range(0, pieces, ix["batch"]):
            b = min(ix["batch"], pieces - start)
            wav = torch.stack([generator.voice_line(n, 16000, ix["voice"], gen, dev)
                               for _ in range(b)])
            rows.append(hub(wav).reshape(-1, hub.encoder.layers[0].fc1.in_features))
    return torch.cat(rows)


class Chain:
    """The reference chain on ``dev``; ``lower`` runs its products in the
    control's format (see ``precision.lowered``)."""

    def __init__(self, cfg: dict, seed: int, dev, index: torch.Tensor, lower: str | None = None):
        self.cfg, self.dev, self.lower = cfg, dev, lower
        s = seeds(seed)
        init = cfg.get("init", {})
        sep, conv = cfg["separator"], cfg["converter"]
        rc = roformer_config(sep)
        self.members = [weights.fill(roformer.BSRoformer(rc).to(dev), s["members"][i],
                                     init.get("roformer")) for i in range(2)]
        self.hubert = weights.fill(hubert.Hubert(**conv["hubert"]).to(dev), s["hubert"],
                                   init.get("hubert"))
        self.rmvpe = weights.fill(rmvpe.RMVPE().to(dev), s["rmvpe"], init.get("rmvpe"))
        self.synth = weights.fill(vits.Synthesizer(synth_config(conv)).to(dev), s["synth"],
                                  init.get("synth"))
        for m in (*self.members, self.hubert, self.rmvpe, self.synth):
            m.eval()
        self.index = index

    # ------------------------------------------------------------ separate

    def _member(self, model, audio):
        sep = self.cfg["separator"]
        sr = sep["sr"]
        p = dsp.plan(audio.shape[-1], int(sep["chunk_s"] * sr), int(sep["overlap_s"] * sr))
        parts = dsp.chunks(audio, p)                               # (count, ch, chunk)
        outs = [model(parts[i:i + sep["reference_batch"]]) for i in
                range(0, p.count, sep["reference_batch"])]
        return {k: dsp.stitch(torch.cat([o[k] for o in outs]), p) for k in outs[0]}

    def separate(self, audio: torch.Tensor) -> dict:
        sep = self.cfg["separator"]
        vs, ins = [], []
        for model in self.members:
            out = self._member(model, audio)
            vs.append(out["vocals"])
            ins.append(out["other"])
        wv = [m["weight_vocals"] for m in sep["members"]]
        wi = [m["weight_inst"] for m in sep["members"]]
        vb, ib = blend(vs, wv), blend(ins, wi)
        return {"vocals": debleed(vb, ib), "instrumental": debleed(ib, vb)}

    # ------------------------------------------------------------ convert

    def knn(self, q: torch.Tensor, k: int = 8) -> torch.Tensor:
        rate = self.cfg["converter"]["index_rate"]
        x = self.index
        d2 = (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[None] - 2.0 * (q @ x.T)
        d2, idx = torch.topk(d2, k, dim=-1, largest=False)
        w = 1.0 / torch.clamp(d2, min=1e-9)
        w = w / w.sum(-1, keepdim=True)
        return rate * torch.einsum("tk,tkd->td", w, x[idx]) + (1.0 - rate) * q

    def convert_group(self, group: torch.Tensor, gen, salience=None) -> tuple:
        """(b, chunk) 16 kHz -> ((b, frames * upp) at the model rate, this
        chain's own RMVPE salience (b, frames, 360)); the synthesizer's
        noise from ``gen``, its pitch decoded from ``salience`` where given
        (the program's, stage by stage), else from its own."""
        own = self.rmvpe.hidden(group)
        f0 = rmvpe.decode(own if salience is None else salience[:, :own.shape[1]])
        feats0 = self.hubert(group)
        b, t, d = feats0.shape
        feats = self.knn(feats0.reshape(b * t, d)).reshape(b, t, d)
        feats = feats.repeat_interleave(2, dim=1)
        feats0 = feats0.repeat_interleave(2, dim=1)
        t100 = min(feats.shape[1], f0.shape[1])
        feats, feats0, f0 = feats[:, :t100], feats0[:, :t100], f0[:, :t100]
        protect = self.cfg["converter"]["protect"]
        keep = torch.where(f0[..., None] > 0, torch.ones_like(f0[..., None]),
                           torch.full_like(f0[..., None], protect))
        feats = feats * keep + feats0 * (1.0 - keep)
        lengths = torch.full((b,), t100, dtype=torch.long, device=group.device)
        sid = torch.zeros(b, dtype=torch.long, device=group.device)
        return self.synth.infer(feats, lengths, dsp.coarse_f0(f0), f0, sid, gen), own

    def convert(self, x16: torch.Tensor, seed: int, salience=None) -> tuple:
        """Mono 16 kHz -> (the take at the model rate, this chain's RMVPE
        salience of every chunk row of every group, padding rows included
        (rows, frames, 360)).  ``salience``: such rows to take the pitch
        from."""
        conv = self.cfg["converter"]
        x = dsp.highpass16k(x16)
        chunk = int(conv["chunk_s"] * 16000)
        chunk -= chunk % 320
        ov = int(conv["overlap_s"] * 16000)
        ov -= ov % 320
        p = dsp.plan(x.shape[-1], chunk, ov)
        parts = dsp.chunks(x, p)
        db = max(1, min(conv["device_batch"], p.count))
        if p.count % db:
            parts = torch.cat([parts, parts.new_zeros((db - p.count % db, chunk))])
        outs = [self.convert_group(parts[g:g + db],
                                   torch.Generator(device=self.dev).manual_seed(seed),
                                   None if salience is None else salience[g:g + db])
                for g in range(0, parts.shape[0], db)]
        out = torch.cat([o[0] for o in outs])[:p.count]
        own = torch.cat([o[1] for o in outs])
        scale = conv["synthesizer"]["sr"] / 16000
        hop = int(round(p.hop * scale))
        op = dsp.Plan(out.shape[-1], hop, int(round(p.n * scale)), p.count,
                      (p.count - 1) * hop + out.shape[-1])
        y = dsp.stitch(out, op)
        peak = y.abs().max()
        return torch.where(peak > 0.99, y * (0.99 / torch.clamp(peak, min=1e-9)), y), own

    @torch.inference_mode()
    def run(self, audio: np.ndarray, seed: int, vocals=None, salience=None) -> dict:
        """Host (2, n) song -> {"vocals", "instrumental": (2, n),
        "converted": (n * 48000 / 44100,), "salience": (rows, frames, 360),
        RMVPE's output on each row of the conversion's groups} on the
        device.  ``vocals``: a (2, n) vocal stem to convert in place of this
        chain's own, and ``salience``: such rows to decode the pitch from in
        place of this chain's own (the stage-by-stage comparison, see
        ``systems/chain.py``)."""
        with precision.fp32_flags(), precision.lowered(self.lower):
            x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.dev)
            stems = self.separate(x)
            v = stems["vocals"] if vocals is None else torch.as_tensor(
                np.asarray(vocals, np.float32)).to(self.dev)
            x16 = dsp.resample(v.mean(dim=0), self.cfg["separator"]["sr"], 16000)
            stems["converted"], stems["salience"] = self.convert(x16, seed, salience)
        return stems


def blend(tracks: list, w: list) -> torch.Tensor:
    """The average at the members' weights and the median, halved."""
    s = torch.stack(tracks)
    ww = torch.tensor(w, dtype=torch.float32, device=s.device)[:, None, None]
    avg = (s * ww).sum(0) / ww.sum()
    srt = s.sort(dim=0).values
    m = s.shape[0]
    med = srt[m // 2] if m % 2 else 0.5 * (srt[m // 2 - 1] + srt[m // 2])
    return 0.5 * (avg + med)


def debleed(t: torch.Tensor, o: torch.Tensor, alpha: float = 0.2, guard: float = 0.5):
    """Subtract ``alpha`` times the projection of ``t`` on ``o`` where the
    two are decorrelated (|cos| <= ``guard``)."""
    a, b = t.reshape(-1).double(), o.reshape(-1).double()
    dot = torch.dot(a, b)
    cos = dot / (a.norm() * b.norm() + 1e-9)
    proj = dot / (torch.dot(b, b) + 1e-9)
    return t - float(cos.abs() <= guard) * alpha * float(proj) * o


def mel_l1(a: torch.Tensor, b: torch.Tensor, sr: int) -> float:
    """Mean absolute difference of the log-mel spectra (80 bins, n_fft
    1024, hop 256, floor 1e-5) of two mono signals, the repository's
    fidelity measure."""
    n = min(a.shape[-1], b.shape[-1])
    ma = torch.log(torch.clamp(dsp.mel(a[..., :n].float(), sr, 1024, 256, 80), min=1e-5))
    mb = torch.log(torch.clamp(dsp.mel(b[..., :n].float(), sr, 1024, 256, 80), min=1e-5))
    return float((ma - mb).abs().mean())


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp(min=1e-30))
