"""Plain reference of RVC v2-48k's GAN training step, fp32 with TF32 off
(upstream train.py: G's loss against the discriminator before this step's
update, LS-GAN adversarial + 2 x feature matching + 45 x mel-L1 + KL, then
D's LS-GAN loss on the detached fake, then AdamW on both with the per-epoch
learning-rate decay 0.999875 applied per update).

It imports nothing of the program.  It reads the dataset's files itself in
the order of RVC's loader (one seeded permutation an epoch, batches of equal
length), computes the spectrograms, draws the step's noise and segment
starts as the published module draws them (one generator per step seeded
from (seed, step)), and builds its modules from the configuration's file
with the program's seeded weights (``benchmark/weights.py``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark import generator, weights
from benchmark.reference import dsp, precision, vits


def seeds(seed: int) -> dict:
    return {"gen": weights.subseed(seed, 20), "disc": weights.subseed(seed, 21),
            "loader": weights.subseed(seed, 22), "step": weights.subseed(seed, 23) % 2 ** 31}


def synth_config(cfg: dict) -> vits.Config:
    return vits.Config(**{k: (tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                              else tuple(v) if isinstance(v, list) else v)
                          for k, v in cfg["synthesizer"].items()})


def step_generator(seed: int, step: int, dev) -> torch.Generator:
    word = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=dev).manual_seed(word)


def draws(cfg: dict, b: int, t: int, seed: int, step: int, dev):
    """(posterior normals (b, t, inter), segment starts (b,) in [0, 2**30),
    excitation normals (b, segment, 1)), in that order from one generator."""
    c = synth_config(cfg)
    g = step_generator(seed, step, dev)
    return (torch.randn((b, t, c.inter_channels), generator=g, device=dev),
            torch.randint(0, 2 ** 30, (b,), generator=g, device=dev),
            torch.randn((b, c.segment_size, 1), generator=g, device=dev))


def batches(cfg: dict, filelist: str, loader_seed: int, count: int, dev) -> list[dict]:
    """The loader's first ``count`` batches: a permutation of the filelist
    per epoch from a numpy generator seeded with ``loader_seed``, each item
    cut to its frames (wav // hop, features at 100 Hz, f0), the batch to its
    shortest, the magnitude spectrogram without centring."""
    m = cfg["mel"]
    entries = json.loads(Path(filelist).read_text())
    rng = np.random.default_rng(loader_seed)
    out, b = [], cfg["batch"]
    while len(out) < count:
        order = rng.permutation(len(entries))
        for i in range(0, len(order) - b + 1, b):
            items = []
            for j in order[i:i + b]:
                e = entries[j]
                wav = generator.read_wav_f32(e["gt"])
                feat = np.repeat(np.load(e["feat"]).astype(np.float32), 2, axis=0)
                f0, f0c = np.load(e["f0"]).astype(np.float32), np.load(e["f0c"]).astype(np.int64)
                t = min(len(wav) // m["hop"], feat.shape[0], len(f0))
                items.append((wav[:t * m["hop"]], feat[:t], f0[:t], f0c[:t], e["sid"], t))
            t = min(it[5] for it in items)
            wav = torch.from_numpy(np.stack([it[0][:t * m["hop"]] for it in items])).to(dev)
            spec = dsp.magnitude(wav, m["n_fft"], m["hop"], center=False)
            tf = spec.shape[1]
            lengths = torch.full((b,), tf, dtype=torch.long, device=dev)
            out.append(dict(
                phone=torch.from_numpy(np.stack([it[1][:tf] for it in items])).to(dev),
                phone_lengths=lengths,
                pitch=torch.from_numpy(np.stack([it[3][:tf] for it in items])).to(dev),
                pitchf=torch.from_numpy(np.stack([it[2][:tf] for it in items])).to(dev),
                spec=spec, spec_lengths=lengths, wave=wav[:, :tf * m["hop"]],
                sid=torch.tensor([it[4] for it in items], dtype=torch.long, device=dev)))
            if len(out) == count:
                break
    return out


def log_mel(wav, cfg):
    m = cfg["mel"]
    mel = dsp.mel(wav, cfg["synthesizer"]["sr"], m["n_fft"], m["hop"], m["n_mels"], center=False)
    return torch.log(torch.clamp(mel, min=1e-5))


class Trainer:
    """G (with the posterior encoder) and D on ``dev`` with their AdamWs;
    ``tf32`` runs the products in TF32 (the control)."""

    def __init__(self, cfg: dict, seed: int, dev, tf32: bool = False):
        self.cfg, self.dev, self.tf32 = cfg, dev, tf32
        s = seeds(seed)
        init = cfg.get("init", {})
        self.gen = weights.fill(vits.Synthesizer(synth_config(cfg), posterior=True).to(dev),
                                s["gen"], init.get("gen")).train()
        self.disc = weights.fill(vits.MPD(tuple(cfg["periods"])).to(dev), s["disc"],
                                 init.get("disc")).train()
        o = cfg["optimizer"]
        self.opts = [torch.optim.AdamW(m.parameters(), lr=o["lr"], betas=tuple(o["betas"]),
                                       eps=o["eps"], weight_decay=0.0)
                     for m in (self.gen, self.disc)]
        self.updates = 0
        self.step_seed = s["step"]

    def leaves(self) -> dict[str, torch.Tensor]:
        return {**{f"gen.{k}": v for k, v in self.gen.named_parameters()},
                **{f"disc.{k}": v for k, v in self.disc.named_parameters()}}

    def step(self, batch: dict, steps_per_epoch: int) -> dict:
        """One step; returns the losses and leaves each gradient in ``.grad``."""
        cfg, c = self.cfg, synth_config(self.cfg)
        o = cfg["optimizer"]
        with precision.fp32_flags(tf32=self.tf32):
            for opt in self.opts:
                opt.zero_grad(set_to_none=True)
            b, t = batch["spec"].shape[:2]
            dr = draws(cfg, b, t, self.step_seed, self.updates, self.dev)
            y_hat, ids, y_mask, (z_p, m_p, logs_p, logs_q) = self.gen(
                batch["phone"], batch["phone_lengths"], batch["pitch"], batch["pitchf"],
                batch["spec"], batch["spec_lengths"], batch["sid"], dr)
            real = vits.segments(batch["wave"][..., None], ids * c.upp, c.segment_size)[..., 0]
            self.disc.requires_grad_(False)
            _, f_outs, r_maps, f_maps = self.disc(real, y_hat)
            self.disc.requires_grad_(True)
            l_adv = vits.g_adv_loss(f_outs)
            l_fm = vits.fm_loss(r_maps, f_maps)
            l_mel = cfg["c_mel"] * torch.mean(torch.abs(log_mel(real, cfg) - log_mel(y_hat, cfg)))
            l_kl = cfg["c_kl"] * vits.kl_loss(z_p, logs_q, m_p, logs_p, y_mask)
            g_total = l_adv + l_fm + l_mel + l_kl
            g_total.backward()
            r_outs, f_outs, _, _ = self.disc(real, y_hat.detach())
            d_total = vits.d_loss(r_outs, f_outs)
            d_total.backward()
            lr = o["lr"] * o["lr_decay"] ** (self.updates / steps_per_epoch)
            for opt in (self.opts[1], self.opts[0]):
                for g in opt.param_groups:
                    g["lr"] = lr
                opt.step()
        self.updates += 1
        losses = {"loss_disc": d_total, "loss_gen_total": g_total, "loss_gen": l_adv,
                  "loss_fm": l_fm, "loss_mel": l_mel, "loss_kl": l_kl}
        return {k: float(v.detach()) for k, v in losses.items()}


def readings(cfg: dict, seed: int, dev, filelist: str, steps_per_epoch: int,
             tf32: bool = False, half: bool = False) -> dict:
    """What the comparison reads from the reference's first steps: each
    step's losses, each leaf's first gradient norm, each leaf's change
    after ``check_steps`` steps.  ``half`` trains on the first half of
    each batch (a planted fault)."""
    tr = Trainer(cfg, seed, dev, tf32)
    start = {k: v.detach().clone() for k, v in tr.leaves().items()}
    losses, grads = [], {}
    for i, batch in enumerate(batches(cfg, filelist, seeds(seed)["loader"], cfg["check_steps"],
                                      dev)):
        if half:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        losses.append(tr.step(batch, steps_per_epoch))
        if i == 0:
            grads = {k: float(v.grad.norm()) for k, v in tr.leaves().items()}
    change = {k: float((v.detach() - start[k]).norm()) for k, v in tr.leaves().items()}
    return {"losses": losses, "grads": grads, "change": change}


def compare(got: dict, ref: dict, limits: dict) -> list[dict]:
    """The gap of each reading from the reference's: each loss's |a - b|
    over the reference's value, by the worst; each leaf's over the
    reference's norm or the median leaf's, whichever is larger, by the
    median leaf: the first gradients over all leaves, the change after
    ``check_steps`` steps over the leaves whose first gradient in the
    reference is at least a thousandth of the median leaf's (a leaf below
    moves under Adam by round-off alone).  The worst leaf is printed, not
    compared: a key's bias under softmax, whose gradient is rounding of far
    larger terms, leads it and reads apart from run to run of one seed."""
    loss, at = max((abs(g[k] - r[k]) / max(abs(r[k]), 1e-12), f"step {i + 1} {k}")
                   for i, (g, r) in enumerate(zip(got["losses"], ref["losses"])) for k in r)
    print(f"reference: loss_rel_gap worst at {at}", file=sys.stderr)

    def gaps(name, keys):
        med = {net: float(np.median([ref[name][k] for k in ref[name] if k.startswith(net)]))
               for net in ("gen.", "disc.")}
        return {k: abs(got[name][k] - ref[name][k])
                / max(ref[name][k], med["gen." if k.startswith("gen.") else "disc."], 1e-30)
                for k in keys}

    def worst(name, g):
        leaf = max(g, key=g.get)
        print(f"reference: {name} gap worst at {leaf} {g[leaf]!r} ({got[name][leaf]!r} against "
              f"{ref[name][leaf]!r})", file=sys.stderr)
        return g[leaf]

    gmed = {net: float(np.median([v for k, v in ref["grads"].items() if k.startswith(net)]))
            for net in ("gen.", "disc.")}
    moving = [k for k, v in ref["grads"].items()
              if v >= 1e-3 * gmed["gen." if k.startswith("gen.") else "disc."]]
    grads, change = gaps("grads", list(ref["grads"])), gaps("change", moving)
    worst("grads", grads)
    worst("change", change)
    return [{"name": "loss_rel_gap", "value": loss, "limit": limits["loss_rel_gap"]},
            {"name": "grad_median_gap", "value": float(np.median(list(grads.values()))),
             "limit": limits["grad_median_gap"]},
            {"name": "change_median_gap", "value": float(np.median(list(change.values()))),
             "limit": limits["change_median_gap"]}]
