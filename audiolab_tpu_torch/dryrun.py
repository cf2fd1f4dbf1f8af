"""Compile-and-run checks of the port's flagship and parallel paths
(counterpart of the JAX package's ``__graft_entry__.py``).

``entry()``             the full v2-48k RVC ``SynthesizerTrn.infer`` on 100
                        frames (1 s), the product's hottest model, as
                        ``(fn, example_args)``: ``fn(*example_args)`` runs.
``dryrun_multichip(n)`` n ranks, one a card under NCCL, each running the
                        four parallel bodies at the JAX dry run's tiny
                        widths: the dp RVC GAN step, the tp LM forward,
                        the dp separation and the dp Zonos ``generate``.

Unlike the JAX dry run there is no fallback: with fewer cards than ranks
under NCCL it raises, and the CPU (gloo) runs only when asked for.

    python -m audiolab_tpu_torch.dryrun            # entry on the card, then
                                                   # dryrun_multichip(cards)
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.utils.fast_init import fast_init


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, example_args)`` for the full v2-48k synthesizer's
    ``infer`` (no noise) on one second of 100 Hz frames, with random weights
    by utils/fast_init's rules, on ``device`` (default the card; raises
    without one)."""
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn, config_for
    from audiolab_tpu_torch.utils.export import _RVCInfer

    dev = resolve_device(device)
    cfg = config_for(48000, "v2")
    fn = _RVCInfer(fast_init(SynthesizerTrn(cfg), 0)).to(dev).eval()
    b, t = 1, 100
    args = (torch.zeros((b, t, cfg.feat_channels), dtype=torch.float32, device=dev),
            torch.full((b,), t, dtype=torch.long, device=dev),
            torch.ones((b, t), dtype=torch.long, device=dev),
            torch.full((b, t), 220.0, dtype=torch.float32, device=dev),
            torch.zeros((b,), dtype=torch.long, device=dev))
    return fn, args


def _gathered(x: torch.Tensor, index: int, count: int, group=None) -> torch.Tensor:
    """Every rank's equal shard ``x`` assembled along the first axis (the
    shards laid in zeros and summed: only ``all_reduce``)."""
    import torch.distributed as dist

    full = x.new_zeros((count * x.shape[0],) + x.shape[1:])
    full[index * x.shape[0]:(index + 1) * x.shape[0]] = x
    dist.all_reduce(full, group=group)
    return full


def _rvc_step(dev, mesh, n: int) -> dict:
    from audiolab_tpu_torch.core.distributed import rows
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig
    from audiolab_tpu_torch.train.rvc import create_train_state, make_train_step

    cfg = SynthesizerConfig(
        spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
        filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
        spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)
    state, _, _ = create_train_state(cfg, seed=0, periods=(2, 3), device=dev)
    step = make_train_step(cfg, mesh=mesh)
    b, t = n, 16
    rng = np.random.default_rng(0)

    def put(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    batch = dict(
        phone=put(rng.standard_normal((b, t, cfg.feat_channels))),
        phone_lengths=put(np.full(b, t), torch.long),
        pitch=put(rng.integers(1, 255, (b, t)), torch.long),
        pitchf=put(rng.uniform(80, 400, (b, t))),
        spec=put(rng.standard_normal((b, t, cfg.spec_channels)) ** 2),
        spec_lengths=put(np.full(b, t), torch.long),
        wave=put(rng.standard_normal((b, t * cfg.upp)) * 0.1),
        sid=put(np.zeros(b), torch.long))
    shard = mesh.coordinate("dp")
    batch = {k: rows(v, shard, mesh.shape["dp"]) for k, v in batch.items()}
    _, metrics = step(state, batch, 1)
    metrics = {k: float(v) for k, v in metrics.items()}
    for k, v in metrics.items():
        if not np.isfinite(v):
            raise AssertionError(f"rvc step: {k} not finite")
    return metrics


def _tp_forward(dev, n: int) -> float:
    import copy

    from audiolab_tpu_torch.core.distributed import rows
    from audiolab_tpu_torch.core.mesh import get_mesh
    from audiolab_tpu_torch.models.lm import LMConfig, TransformerLM
    from audiolab_tpu_torch.parallel import shard_lm_params

    tp = 2 if n % 2 == 0 else 1
    mesh = get_mesh(tp)
    cfg = LMConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=64,
                   max_seq_len=32, dtype="float32")
    lm = fast_init(TransformerLM(cfg), 2).to(dev).eval()
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (n // tp, 8))).to(dev)
    toks = rows(toks, mesh.coordinate("dp"), mesh.shape["dp"])
    with torch.no_grad():
        ref, _ = lm(toks)
        out, _ = shard_lm_params(copy.deepcopy(lm), mesh)(toks)
    if not torch.isfinite(out).all():
        raise AssertionError("tp forward: logits not finite")
    err = float((out - ref).abs().max())
    if err > 2e-4 * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"tp forward: {err} from the replicated forward")
    return err


def _separation(dev, mesh, n: int) -> float:
    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
    from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator

    cfg = RoformerConfig(dim=16, depth=1, heads=2, n_fft=64, hop=32, freqs_per_bands=(16, 17),
                         channels=1, stems=("vocals",), residual_stem="other",
                         dtype="float32")
    model = fast_init(BSRoformer(cfg), 3)
    sr, chunk = 8000, 256
    audio = (0.1 * np.random.default_rng(3).standard_normal((1, chunk * n))).astype(np.float32)
    kw = dict(sr=sr, chunk_seconds=chunk / sr, overlap_seconds=32 / sr, device_batch=n,
              matmul_precision="highest")
    out = StemSeparator([EnsembleMember("roformer", model)], mesh=mesh, **kw).separate(audio)
    ref = StemSeparator([EnsembleMember("roformer", model)], device=dev, **kw).separate(audio)
    err = 0.0
    for stem, v in out.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"separation: stem {stem} not finite")
        err = max(err, float(np.abs(v - ref[stem]).max()))
    if err > 1e-5:
        raise AssertionError(f"separation: {err} from the unsharded separator")
    return err


def _zonos(dev, mesh, n: int) -> list:
    from audiolab_tpu_torch.models.lm import gumbel_draws
    from audiolab_tpu_torch.models.zonos import ZonosConfig, ZonosModel, generate

    zc = ZonosConfig(dim=32, n_layers=2, attn_every=2, n_heads=2, d_state=4, n_codebooks=3,
                     codebook_size=40, spk_dim=8)
    model = fast_init(ZonosModel(zc), 4).to(dev).eval()
    dp, shard = mesh.shape["dp"], mesh.coordinate("dp")
    per = n // dp

    def draws(total, rows_, vocab):
        full = gumbel_draws(total, n * zc.n_codebooks, vocab, 5, dev)
        full = full.reshape(total, n, zc.n_codebooks, vocab)[:, shard * per:(shard + 1) * per]
        return full.reshape(total, rows_, vocab)

    text = torch.zeros((per, 8), dtype=torch.long, device=dev)
    spk = torch.zeros((per, zc.spk_dim), device=dev)
    codes = generate(model, text, spk, max_frames=6, draws=draws, device=dev)
    codes = _gathered(codes, shard, dp, mesh.group("dp"))
    if codes.shape[0] != n or int(codes.min()) < 0 or int(codes.max()) >= zc.codebook_size:
        raise AssertionError(f"zonos: codes {tuple(codes.shape)} in "
                             f"[{int(codes.min())}, {int(codes.max())}]")
    return codes.cpu().tolist()


def _rank_body(rank: int, n: int, device: str, backend: str | None, store: str) -> dict:
    from audiolab_tpu_torch.core.distributed import init_distributed, rank_device
    from audiolab_tpu_torch.core.mesh import get_mesh

    info = init_distributed(num_processes=n, process_id=rank, backend=backend, device=device,
                            init_method=store, timeout=600)
    dev = rank_device()
    mesh = get_mesh()
    return {"info": info, "device": str(dev), "rvc": _rvc_step(dev, mesh, n),
            "tp_err": _tp_forward(dev, n), "sep_err": _separation(dev, mesh, n),
            "zonos": _zonos(dev, mesh, n)}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     backend: str | None = None, timeout: float = 900.0) -> list[dict]:
    """Runs the four parallel bodies in ``n_devices`` spawned ranks: under
    NCCL (``device`` "cuda", the default) one rank per card, raising when
    the host has fewer; ``backend="gloo"`` lets ranks share cards;
    ``device="cpu"`` takes gloo on the CPU.  Each rank checks its own
    results (finite, the tp forward within 2e-4 of the replicated one, the
    separation within 1e-5 of the unsharded one, Zonos's codes in range)
    and returns them; returns the ranks' results."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        cards = torch.cuda.device_count()
        if (backend or "nccl") == "nccl" and cards < n_devices:
            raise RuntimeError(f"NCCL takes one rank per card: {n_devices} ranks need "
                               f"{n_devices} cards, the host has {cards}")
    from audiolab_tpu_torch.core.distributed import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_rank_body, n_devices,
                         (n_devices, dev.type, backend, f"file://{tmp}/store"),
                         timeout=timeout)


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
