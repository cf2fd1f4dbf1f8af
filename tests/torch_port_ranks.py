"""The rank bodies of tests/test_torch_port_parallel.py: port code only (no
JAX), run in two spawned gloo ranks on the CPU by
``core.distributed.run_ranks``.  The parent writes the inputs (weights,
batches, the JAX keys' draws) with ``torch.save``; each rank returns its
results, tensors as numpy arrays."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
from pathlib import Path

import torch

from audiolab_tpu_torch.core.distributed import init_distributed, rows
from audiolab_tpu_torch.core.mesh import get_mesh
from audiolab_tpu_torch.models.layers import Pins, pinned
from audiolab_tpu_torch.models.lm import TransformerLM
from audiolab_tpu_torch.models.rvc.discriminator import MultiPeriodDiscriminatorV2
from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn, TrainDraws
from audiolab_tpu_torch.models.separation.roformer import BSRoformer
from audiolab_tpu_torch.parallel import shard_lm_params
from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator
from audiolab_tpu_torch.train import rvc as TR
from audiolab_tpu_torch.train import trainer as TT
from audiolab_tpu_torch.train import wavetransfer as TWT


def _rvc(inp: dict, mesh) -> dict:
    """The data-parallel GAN step on this rank's shard, in fp32 replaying
    the pins its own fp64 step recorded (as the single-process parity test
    does on the whole batch)."""
    cfg, shard, dp = inp["cfg"], mesh.coordinate("dp"), mesh.shape["dp"]
    pins = Pins()

    def port_step(dtype, replay):
        gen = SynthesizerTrn(cfg, posterior=True)
        gen.load_state_dict(inp["gen"])
        disc = MultiPeriodDiscriminatorV2(inp["periods"])
        disc.load_state_dict(inp["disc"])
        gen, disc = gen.train().to(dtype), disc.train().to(dtype)
        state = TR.RVCTrainState(0, gen, disc, TR.make_optimizer(gen.parameters()),
                                 TR.make_optimizer(disc.parameters()))
        batch = {k: rows(v.to(dtype) if v.is_floating_point() else v, shard, dp)
                 for k, v in inp["batch"].items()}
        d = inp["draws"]
        draws = TrainDraws(d.posterior.to(dtype), d.starts, d.sine.to(dtype))
        with pinned(pins, replay=replay):
            state, metrics = TR.make_train_step(cfg, mesh=mesh)(state, batch, 1, draws=draws)
        return gen, disc, metrics

    port_step(torch.float64, False)
    gen, disc, metrics = port_step(torch.float32, True)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "gen": {k: p.grad for k, p in gen.named_parameters()},
            "disc": {k: p.grad for k, p in disc.named_parameters()},
            "flips": pins.flips}


def _wavetransfer(inp: dict, project: Path) -> dict:
    """``train_model`` for the configured steps on the global batches; rank 0
    writes the checkpoints under ``project``."""
    batches = iter(inp["batches"])
    res = TWT.train_model(str(project), inp["cfg"], segment_gen=batches, device="cpu",
                          draws=lambda step, b, n: inp["draws"][step])
    return {"loss": res["loss"], "written": sorted(p.name for p in (project / "ckpt").iterdir())}


def _wavetransfer_refused(inp: dict, project: Path) -> dict:
    """``train_model`` with a batch of 3, which two ranks cannot split:
    the ``ValueError`` it raises and whether it wrote anything."""
    cfg = dataclasses.replace(inp["cfg"], batch_size=3)
    try:
        TWT.train_model(str(project), cfg, segment_gen=iter(inp["batches"]), device="cpu")
    except ValueError as e:
        return {"error": str(e), "written": project.exists()}
    return {"error": None, "written": project.exists()}


def _tp(inp: dict) -> dict:
    """Each LM of ``inp`` replicated and under tp = 2 on the same tokens."""
    mesh = get_mesh(2)
    out = {}
    for name, (cfg, sd, toks) in inp.items():
        lm = TransformerLM(cfg).eval()
        lm.load_state_dict(sd)
        with torch.no_grad():
            ref, _ = lm(toks)
            tp = shard_lm_params(copy.deepcopy(lm), mesh)
            got, _ = tp(toks)
        heads = (tp.model.layers[0].self_attn.n_heads, tp.model.layers[0].self_attn.n_kv_heads)
        out[name] = {"replicated": ref, "tp": got, "heads": heads,
                     "q_rows": tp.model.layers[0].self_attn.q_proj.weight.shape[0]}
    return out


def _separate(inp: dict, mesh) -> dict:
    """``StemSeparator`` over the ranks' dp axis, counting the chunks each
    rank's member call takes."""
    seen = []
    members = []
    for name, (cfg, sd, wv, wi) in inp["members"].items():
        model = BSRoformer(cfg).eval()
        model.load_state_dict(sd)

        def counted(batch, model=model):
            seen.append(batch.shape[0])
            return model(batch)

        members.append(EnsembleMember(name, counted, wv, wi))
    out = StemSeparator(members, mesh=mesh, **inp["kw"]).separate(inp["audio"])
    return {"stems": out, "calls": seen}


def _trainer(inp: dict) -> dict:
    """The trainer's command line in the started group: one epoch of the
    prepared experiment, each rank its shard of every batch."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        TT.main([inp["exp"], "--device", "cpu", "--batch-size", "2", "--epochs", "1",
                 "--save-every-epoch", "1", "--no-early-stop",
                 "--synth-overrides", json.dumps(inp["synth"])])
    return {"printed": printed.getvalue(),
            "state": json.loads((Path(inp["exp"]) / "train_state.json").read_text())}


def body(rank: int, store: str, inputs: str, work: str) -> dict:
    info = init_distributed(num_processes=2, process_id=rank, device="cpu", init_method=store,
                            timeout=120)
    inp = torch.load(inputs, weights_only=False)
    mesh = get_mesh()
    return {"info": info, "dp": mesh.shape["dp"], "rvc": _rvc(inp["rvc"], mesh),
            "wavetransfer": _wavetransfer(inp["wavetransfer"], Path(work) / "wt"),
            "wt_refused": _wavetransfer_refused(inp["wavetransfer"], Path(work) / "wt_odd"),
            "tp": _tp(inp["tp"]), "separate": _separate(inp["separate"], mesh),
            "trainer": _trainer(inp["trainer"])}
