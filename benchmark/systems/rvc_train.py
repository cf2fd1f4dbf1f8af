"""RVC v2-48k training through the port's step and loader:
``train.data.RVCDataLoader.batches`` over the traffic's dataset, written
where RVC's ``write_filelist`` would leave it, and ``train.rvc.make_train_step``
on an ``RVCTrainState`` of the synthesizer (with its posterior encoder), the
multi-period discriminator and their ``DecayedAdamW``s, as
``train/trainer.py`` builds them; the weights are the benchmark's.

Set-up drives the state through its first ``check_steps`` steps by the
window's own call and feed, and reads each step's losses, each leaf's first
gradient (from the optimizer's first moment) and each leaf's change after
them; the window then continues the same object.  ``check`` holds those
readings against the plain reference's first steps.

``PATCHES`` put the reference in the program's place in TF32 (the control)
or plant a fault in the timed path; ``run.py --patch <name>`` applies one.
"""

from __future__ import annotations

import itertools
import json
import shutil
import tempfile
from pathlib import Path

import torch

from benchmark import generator, harness, weights
from benchmark.work import flops as flop_count


def _reference(cfg: dict):
    return harness.load_module(harness.ROOT / "reference" / cfg["name"] / "reference.py",
                               "benchmark_reference_" + cfg["name"].replace("-", "_"))


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev, spans):
        self.cfg, self.mix, self.seed, self.dev, self.span = cfg, mix, seed, dev, spans
        self.ref = _reference(cfg)
        self.lower = None          # the control: the reference in the program's place in TF32
        self.dir = Path(tempfile.mkdtemp(prefix="benchmark_rvc_"))

    def setup(self):
        cfg = self.cfg
        s = self.ref.seeds(self.seed)
        self.filelist = generator.rvc_dataset(self.mix, cfg["slices"], self.seed, self.dir)
        self.steps_per_epoch = max(1, cfg["slices"] // cfg["batch"])
        if self.lower is None:
            self._build_port(s)
        else:
            tr = self.ref.Trainer(cfg, self.seed, self.dev, tf32=self.lower == "tf32")
            self.batches = itertools.cycle(self.ref.batches(
                cfg, self.filelist, s["loader"], cfg["check_steps"] + 1, self.dev))
            self._run_step = lambda batch: tr.step(batch, self.steps_per_epoch)
            self._nets = (tr.gen, tr.disc)
            self._opts = tr.opts
        self.readings = self._first_steps()

    def _build_port(self, s: dict):
        from audiolab_tpu_torch.models.rvc.discriminator import MultiPeriodDiscriminatorV2
        from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig, SynthesizerTrn
        from audiolab_tpu_torch.train.data import LoaderConfig, RVCDataLoader
        from audiolab_tpu_torch.train.rvc import RVCTrainState, make_optimizer, make_train_step

        cfg, dev = self.cfg, self.dev
        init = cfg.get("init", {})
        sc = SynthesizerConfig(**{k: (tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                                      else tuple(v) if isinstance(v, list) else v)
                                  for k, v in cfg["synthesizer"].items()})
        with torch.device(dev):
            gen = SynthesizerTrn(sc, posterior=True)
            disc = MultiPeriodDiscriminatorV2(tuple(cfg["periods"]))
        weights.fill(gen, s["gen"], init.get("gen"))
        weights.fill(disc, s["disc"], init.get("disc"))
        m = cfg["mel"]
        loader = RVCDataLoader(self.filelist, LoaderConfig(
            sr=sc.sr, n_fft=m["n_fft"], hop=m["hop"], win_length=m["n_fft"],
            batch_size=cfg["batch"], seed=s["loader"]), device=dev)
        self.steps_per_epoch = max(1, len(loader))
        o = cfg["optimizer"]

        def opt(params):
            return make_optimizer(params, o["lr"], tuple(o["betas"]), o["eps"], o["lr_decay"],
                                  self.steps_per_epoch)

        self.state = RVCTrainState(step=0, gen=gen.train(), disc=disc.train(),
                                   g_opt=opt(gen.parameters()), d_opt=opt(disc.parameters()))
        step_fn = make_train_step(sc, c_mel=cfg["c_mel"], c_kl=cfg["c_kl"])
        self.batches = loader.batches(epochs=1 << 40)

        def run_step(batch):
            self.state, metrics = step_fn(self.state, batch, s["step"])
            return metrics
        self._run_step = run_step
        self._nets = (self.state.gen, self.state.disc)
        self._opts = (self.state.g_opt, self.state.d_opt)

    def _leaves(self) -> dict[str, torch.Tensor]:
        gen, disc = self._nets
        return {**{f"gen.{k}": v for k, v in gen.named_parameters()},
                **{f"disc.{k}": v for k, v in disc.named_parameters()}}

    def _first_steps(self) -> dict:
        """The first ``check_steps`` steps by the window's call and feed; the
        readings the reference's are held against."""
        beta1 = self.cfg["optimizer"]["betas"][0]
        start = {k: v.detach().cpu().clone() for k, v in self._leaves().items()}
        losses, grads = [], {}
        for i in range(self.cfg["check_steps"]):
            metrics = self._step()
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                # the first gradient as the optimizer got it: m1 = (1 - beta1) g
                opt_state = {k: v for o in self._opts for k, v in o.state.items()}
                grads = {k: float(opt_state[v]["exp_avg"].norm()) / (1.0 - beta1)
                         if v in opt_state else 0.0 for k, v in self._leaves().items()}
        change = {k: float((v.detach().cpu() - start[k]).norm())
                  for k, v in self._leaves().items()}
        return {"losses": losses, "grads": grads, "change": change}

    def _step(self):
        with self.span("loader"):
            batch = next(self.batches)
        with self.span("step"):
            return self._run_step(batch)

    def serve(self, rec):
        metrics = self._step()
        rec.units["steps"] = 1
        rec.ok = bool(torch.isfinite(torch.as_tensor(metrics["loss_gen_total"])))

    def work(self, records) -> dict:
        steps = sum(r.units.get("steps", 0) for r in records)
        return {"attention": [], "model_flops": steps * step_flops(self.cfg, self.mix, self.ref)}

    def release(self):
        for name in ("state", "batches", "_run_step", "_nets", "_opts"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, records) -> list[dict]:
        try:
            ref = self.ref.readings(self.cfg, self.seed, self.dev, self.filelist,
                                    self.steps_per_epoch)
            return self.ref.compare(self.readings, ref, self.cfg["limits"])
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def step_flops(cfg: dict, mix: dict, ref) -> float:
    """Products of one training step at the cell's batch: the reference's
    step run on meta tensors, forward and backward of G and D."""
    return _step_flops(json.dumps([cfg, mix], sort_keys=True), ref)


_CACHE: dict = {}


def _step_flops(key: str, ref) -> float:
    if key in _CACHE:
        return _CACHE[key]
    cfg, mix = json.loads(key)
    meta = torch.device("meta")
    from benchmark.reference import vits

    c = ref.synth_config(cfg)
    b = cfg["batch"]
    m = cfg["mel"]
    n = int(round(mix["slice_s"] * c.sr))
    n16 = n * 16000 // c.sr
    t = min(n // m["hop"], 2 * ((n16 - 400) // 320 + 1), 1 + n16 // 160)
    frames = (t * m["hop"] - m["n_fft"]) // m["hop"] + 1      # the loader's uncentred STFT
    with meta:
        gen = vits.Synthesizer(c, posterior=True)
        disc = vits.MPD(tuple(cfg["periods"]))
    lengths = torch.full((b,), frames, dtype=torch.long, device=meta)
    batch = dict(phone=torch.zeros(b, frames, c.feat_channels, device=meta),
                 pitch=torch.zeros(b, frames, dtype=torch.long, device=meta),
                 pitchf=torch.zeros(b, frames, device=meta),
                 spec=torch.zeros(b, frames, c.spec_channels, device=meta),
                 wave=torch.zeros(b, frames * m["hop"], device=meta),
                 sid=torch.zeros(b, dtype=torch.long, device=meta))
    dr = (torch.zeros(b, frames, c.inter_channels, device=meta),
          torch.zeros(b, dtype=torch.long, device=meta),
          torch.zeros(b, c.segment_size, 1, device=meta))

    def run():
        y_hat, ids, y_mask, (z_p, m_p, logs_p, logs_q) = gen(
            batch["phone"], lengths, batch["pitch"], batch["pitchf"], batch["spec"], lengths,
            batch["sid"], dr)
        real = vits.segments(batch["wave"][..., None], ids * c.upp, c.segment_size)[..., 0]
        disc.requires_grad_(False)
        _, f_outs, r_maps, f_maps = disc(real, y_hat)
        disc.requires_grad_(True)
        loss = vits.g_adv_loss(f_outs) + vits.fm_loss(r_maps, f_maps) \
            + torch.mean(torch.abs(ref.log_mel(real, cfg) - ref.log_mel(y_hat, cfg))) \
            + vits.kl_loss(z_p, logs_q, m_p, logs_p, y_mask)
        loss.backward()
        r_outs, f_outs, _, _ = disc(real, y_hat.detach())
        vits.d_loss(r_outs, f_outs).backward()

    _CACHE[key] = flop_count.count(run)
    return _CACHE[key]


def _tf32(system):
    system.lower = "tf32"


def _wrap_step(wrap):
    """A patch that wraps the program's step function as ``wrap(step)``."""
    def patch(system):
        import audiolab_tpu_torch.train.rvc as R

        real = R.make_train_step

        def make(*a, **k):
            return wrap(real(*a, **k))
        R.make_train_step = make
    return patch


def _unchanged(step):
    """A step that returns its state unchanged."""
    def frozen(state, batch, seed, draws=None):
        g, d = state.g_opt.step, state.d_opt.step
        state.g_opt.step = state.d_opt.step = lambda *x, **y: None
        try:
            return step(state, batch, seed, draws)
        finally:
            state.g_opt.step, state.d_opt.step = g, d
    return frozen


def _half(step):
    """Half of the batch left out, the mean taken over the rest."""
    def half(state, batch, seed, draws=None):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, seed, draws)
    return half


def _altered(step):
    """A loss altered where it is produced."""
    def altered(state, batch, seed, draws=None):
        state, m = step(state, batch, seed, draws)
        return state, {**m, "loss_mel": m["loss_mel"] * 1.05}
    return altered


PATCHES = {"tf32": _tf32, "unchanged_state": _wrap_step(_unchanged),
           "half_batch": _wrap_step(_half), "altered_answer": _wrap_step(_altered)}
