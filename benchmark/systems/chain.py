"""The separate -> convert chain through the port's entry points:
``StemSeparator.separate`` (an ensemble of BS-RoFormer members), the mono
mix resampled on the device (``kernels.resample.resample``), and
``VoiceConverter.convert`` (HuBERT, retrieval, RMVPE, the synthesizer).
One song at a time, as the product runs card work under one inference lock;
every stem and the converted vocals come back to the host, as the user gets
them.

``check`` runs the plain reference (``reference/<config>/reference.py``) on
one song of the window, drawn from the seed, stage by stage: its separation
of the song against the program's stems; its RMVPE on the program's vocal
stem against the salience the program's RMVPE gave in the window; and its
conversion of the program's vocal stem, with the pitch decoded from the
program's salience, against the program's converted take.  Each stage
takes the program's output of the stage before: end to end, the
separator's rounding moves the converter's input, and RMVPE's argmax turns
a small change of its salience into a pitch on another bin, which moves
the excitation's phase for the rest of its chunk and would hide the later
stages' own precision.  The song is drawn from the seed as the window
goes (one kept, each new one taking its place with chance 1 / its
number), so only its outputs are held.

``PATCHES`` put the reference in the program's place in fp8 (the control)
or plant a fault in the timed path; ``run.py --patch <name>`` applies one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, harness, weights
from benchmark.work import attention as attention_work
from benchmark.work import flops as flop_count


def _reference(cfg: dict):
    return harness.load_module(harness.ROOT / "reference" / cfg["name"] / "reference.py",
                               "benchmark_reference_" + cfg["name"].replace("-", "_"))


def separator_groups(n: int, sep: dict) -> list[int]:
    """The separator's batch sizes for one member on an ``n``-sample song,
    one entry a device batch (its chunk plan, balanced over the groups)."""
    sr = sep["sr"]
    chunk, ov = int(sep["chunk_s"] * sr), int(sep["overlap_s"] * sr)
    count = max(1, -(-max(n - ov, 1) // (chunk - ov)))
    db = max(1, min(sep["device_batch"], count))
    groups = -(-count // db)
    db = -(-count // groups)
    return [db] * groups


def converter_chunks(n16: int, conv: dict) -> int:
    """The converter's chunk count on an ``n16``-sample 16 kHz track."""
    chunk = int(conv["chunk_s"] * 16000)
    chunk -= chunk % 320
    ov = int(conv["overlap_s"] * 16000)
    ov -= ov % 320
    return max(1, -(-max(n16 - ov, 1) // (chunk - ov)))


def converter_groups(n16: int, conv: dict) -> list[int]:
    count = converter_chunks(n16, conv)
    db = max(1, min(conv["device_batch"], count))
    return [db] * (-(-count // db))


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev, spans):
        self.cfg, self.mix, self.seed, self.dev, self.span = cfg, mix, seed, dev, spans
        self.ref = _reference(cfg)
        self.lower = None          # the control: the reference in this format in the program's place
        self.pick = np.random.default_rng(weights.subseed(seed, 5))
        self.sample = None
        self.i = 0

    # ------------------------------------------------------------ set-up

    def setup(self):
        cfg, dev = self.cfg, self.dev
        # the voice's retrieval rows: an input the benchmark makes (RVC's
        # index of the voice's training features through the reference's
        # HuBERT), handed to both sides; its seconds are the reference's
        # and are left out of setup_s
        t0 = time.perf_counter()
        self.index = self.ref.index_rows(cfg, self.seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self.reference_s = time.perf_counter() - t0
        self.items = generator.songs(self.mix, self.seed, dev)
        if self.lower is None:
            self._build_port()
            self._warm()
        else:
            ctl = self.ref.Chain(cfg, self.seed, dev, self.index, lower=self.lower)

            def chain(audio, seed):
                out = ctl.run(audio, seed)
                return {**{k: v.cpu().numpy() for k, v in out.items() if k != "salience"},
                        "salience": [out["salience"]]}
            self._chain = chain

    def _build_port(self):
        from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
        from audiolab_tpu_torch.models.rmvpe import RMVPE
        from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig, SynthesizerTrn
        from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
        from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
        from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator

        cfg, dev = self.cfg, self.dev
        sep, conv = cfg["separator"], cfg["converter"]
        s = self.ref.seeds(self.seed)
        init = cfg.get("init", {})
        rc = RoformerConfig(dim=sep["dim"], depth=sep["depth"], heads=sep["heads"],
                            dim_head=sep["dim_head"], stems=tuple(sep["stems"]),
                            residual_stem=sep["residual_stem"],
                            freqs_per_bands=tuple(sep["freqs_per_bands"]), n_fft=sep["n_fft"],
                            hop=sep["hop"], channels=sep["channels"], ff_mult=sep["ff_mult"],
                            mask_est_depth=sep["mask_est_depth"], dtype=sep["dtype"])
        members = []
        for i, m in enumerate(sep["members"]):
            with torch.device(dev):
                model = BSRoformer(rc)
            weights.fill(model, s["members"][i], init.get("roformer"))
            members.append(EnsembleMember(m["name"], model, m["weight_vocals"],
                                          m["weight_inst"]))
        self.sep = StemSeparator(members, sr=sep["sr"], chunk_seconds=sep["chunk_s"],
                                 overlap_seconds=sep["overlap_s"],
                                 device_batch=sep["device_batch"],
                                 matmul_precision=sep["matmul_precision"], device=dev)
        sc = SynthesizerConfig(**{k: (tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                                      else tuple(v) if isinstance(v, list) else v)
                                  for k, v in conv["synthesizer"].items()})
        with torch.device(dev):
            synth = SynthesizerTrn(sc)
            hub = HubertFeatureExtractor("v2", HubertConfig(**conv["hubert"]))
            f0 = RMVPE(dtype=conv["rmvpe_dtype"])
        weights.fill(synth, s["synth"], init.get("synth"))
        weights.fill(hub, s["hubert"], init.get("hubert"))
        weights.fill(f0, s["rmvpe"], init.get("rmvpe"))
        self.vc = VoiceConverter(
            synth, hub, f0, index_features=self.index, device=dev,
            cfg=RVCPipelineConfig(version="v2", sr=sc.sr, chunk_seconds=conv["chunk_s"],
                                  overlap_seconds=conv["overlap_s"], f0_method=conv["f0_method"],
                                  device_batch=conv["device_batch"],
                                  matmul_precision=conv["matmul_precision"]))
        # the salience the program's RMVPE gives each group, kept for the check
        forward = self.vc.rmvpe.forward
        self.salience = []

        def recorded(mel):
            out = forward(mel)
            self.salience.append(out)
            return out
        self.vc.rmvpe.forward = recorded

    def _warm(self):
        """A whole chain at every separator batch size this seed's songs use
        (one group of that many chunks); the songs' own lengths change only
        elementwise and FFT sizes."""
        sep = self.cfg["separator"]
        sr = sep["sr"]
        chunk, hop = int(sep["chunk_s"] * sr), int((sep["chunk_s"] - sep["overlap_s"]) * sr)
        sizes = sorted({db for it in self.items
                        for db in separator_groups(it["audio"].shape[-1], sep)})
        gen = np.random.default_rng(0)
        for db in sizes:
            audio = (0.1 * gen.standard_normal((2, (db - 1) * hop + chunk))).astype(np.float32)
            self._chain(audio, 0)

    # ------------------------------------------------------------ window

    def _chain(self, audio: np.ndarray, seed: int) -> dict:
        from audiolab_tpu_torch.kernels.resample import resample

        conv = self.cfg["converter"]
        self.salience = []
        with self.span("separate"):
            stems = self.sep.separate(audio, as_numpy=False)
        with self.span("convert"):
            x16 = resample(stems["vocals"].mean(dim=0), self.cfg["separator"]["sr"], 16000)
            out = self.vc.convert(x16, sid=0, seed=seed, index_rate=conv["index_rate"],
                                  protect=conv["protect"], as_numpy=True)
        with self.span("handover"):
            host = {k: v.cpu().numpy() for k, v in stems.items()}
        host["converted"] = out
        host["salience"] = self.salience
        return host

    def serve(self, rec):
        from audiolab_tpu_torch.kernels import attention as A

        item = self.items[self.i % len(self.items)]
        self.i += 1
        k1, k2 = A.attention_nk1.launches, A.flash_attention_fwd.launches
        out = self._chain(item["audio"], item["seed"])
        n = item["audio"].shape[-1]
        sr = self.cfg["separator"]["sr"]
        rec.units["audio_s"] = n / sr
        rec.units["samples"] = n
        rec.counters = {"K1": A.attention_nk1.launches - k1,
                        "K2": A.flash_attention_fwd.launches - k2}
        n_out = int(round(int(np.ceil(n * 16000 / sr)) * 48000 / 16000))
        rec.ok = (out["vocals"].shape == (2, n) and out["converted"].shape == (n_out,)
                  and all(np.isfinite(v).all() for k, v in out.items() if k != "salience"))
        if self.pick.random() * self.i < 1.0:
            self.sample = (item, out)

    # ------------------------------------------------------------ work

    def work(self, records) -> dict:
        """Attention calls and model products of the window's songs, from
        their shapes (``benchmark/work``)."""
        return chain_work(self.cfg, [r.units["samples"] for r in records])

    def release(self):
        for name in ("sep", "vc", "_chain"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def check(self, records) -> list[dict]:
        item, got = self.sample
        self.sample = None
        frames = int(np.ceil(item["audio"].shape[-1] * 16000 / self.cfg["separator"]["sr"]))
        rows = converter_chunks(frames, self.cfg["converter"])
        got["salience"] = torch.cat(got["salience"]).to(self.dev)
        chain = self.ref.Chain(self.cfg, self.seed, self.dev, self.index)
        ref = chain.run(item["audio"], item["seed"], vocals=got["vocals"],
                        salience=got["salience"])
        return compare(self.ref, self.cfg, got, ref, rows)


def compare(ref_mod, cfg: dict, got: dict, ref: dict, rows: int) -> list[dict]:
    """The numbers the cell compares, each beside its limit; ``rows``: the
    conversion's chunks (the groups' padding rows left out)."""
    lim = cfg["limits"]
    dev = ref["vocals"].device

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    frames = ref["salience"].shape[1]
    return [
        {"name": "vocals_rel_l2", "value": ref_mod.rel_l2(t(got["vocals"]), ref["vocals"]),
         "limit": lim["vocals_rel_l2"]},
        {"name": "instrumental_rel_l2",
         "value": ref_mod.rel_l2(t(got["instrumental"]), ref["instrumental"]),
         "limit": lim["instrumental_rel_l2"]},
        {"name": "salience_rel_l2",
         "value": ref_mod.rel_l2(got["salience"][:rows, :frames], ref["salience"][:rows]),
         "limit": lim["salience_rel_l2"]},
        {"name": "converted_mel_l1",
         "value": ref_mod.mel_l1(t(got["converted"]), ref["converted"],
                                 cfg["converter"]["synthesizer"]["sr"]),
         "limit": lim["converted_mel_l1"]},
    ]


def chain_work(cfg: dict, songs: list[int]) -> dict:
    """Per song: each member's separator batches run the RoFormer (K1 on
    both axes of every depth step), each converter group runs HuBERT (K2 in
    every layer), RMVPE, the retrieval search and the synthesizer."""
    sep, conv = cfg["separator"], cfg["converter"]
    calls, flops = [], 0.0
    for n in songs:
        for db in separator_groups(n, sep) * len(sep["members"]):
            calls += attention_work.roformer_calls(sep, db)
            flops += db * flop_count.per_item("roformer", cfg)
        n16 = int(np.ceil(n * 16000 / sep["sr"]))
        for db in converter_groups(n16, conv):
            calls += attention_work.hubert_calls(conv, db)
            flops += db * flop_count.per_item("converter", cfg)
    return {"attention": calls, "model_flops": flops}


def _lowered(fmt: str):
    def patch(system):
        system.lower = fmt
    return patch


def _altered_take(system):
    """A converted take altered where it is produced."""
    from audiolab_tpu_torch.pipelines.rvc import VoiceConverter

    real = VoiceConverter.convert

    def convert(self, *a, **k):
        return real(self, *a, **k) * 0.9
    VoiceConverter.convert = convert


def _half_batch(system):
    """Half of each separator batch left out: its rows come back empty."""
    from audiolab_tpu_torch.pipelines.separate import StemSeparator

    real = StemSeparator._apply

    def apply(self, member, batch):
        out = real(self, member, batch)
        h = batch.shape[0] // 2
        return {k: v.clone().index_fill_(0, torch.arange(h, v.shape[0], device=v.device), 0.0)
                for k, v in out.items()}
    StemSeparator._apply = apply


def _salience_altered(system):
    """RMVPE's salience altered where it is produced."""
    from audiolab_tpu_torch.models.rmvpe import E2E

    real = E2E.forward

    def forward(self, mel):
        return real(self, mel) * 0.9
    E2E.forward = forward


def _f0_shifted(system):
    """RMVPE's f0 altered where it is produced: a semitone up."""
    from audiolab_tpu_torch.models.rmvpe import RMVPE

    real = RMVPE.infer

    def infer(self, *a, **k):
        return real(self, *a, **k) * 2.0 ** (1.0 / 12.0)
    RMVPE.infer = infer


PATCHES = {"fp8": _lowered("fp8"), "altered_answer": _altered_take, "half_batch": _half_batch,
           "salience_altered": _salience_altered, "f0_shifted": _f0_shifted}
