"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main path's shapes,
drives the separate -> RVC chain at full width, and checks the output.

    python3 chip_smoke.py                          # every phase, one card
    python3 chip_smoke.py --phases card,kernels    # a subset
    python3 chip_smoke.py --profile DIR            # + a profiler table of one chain pass

Phases, one line each (any failure exits non-zero, and no result is printed):

  card       nvidia-smi name and power limit, torch/CUDA versions, build seconds
  kernels    K1 and K2 against their plain versions at the main path's shapes;
             K3-K7 (off the chain) against theirs at the RoFormer's shapes,
             and the three comparisons the TPU probes were written for
  separator  two BS-RoFormer members (dim 512, 12 axial pairs, 8 heads x 64,
             distinct seeded weights) on a 60 s stereo 44.1 kHz track: 8 chunks,
             one device batch; 48 K1 launches
  rvc        mono mix, 44.1 -> 16 kHz, VoiceConverter.convert at v2-48k with full
             HuBERT, full RMVPE and a 4096 x 768 index; 12 K2 launches
  fidelity   the same RVC input under the fp32 and the bf16 matmul policy:
             mel-L1 < 1e-2 (BASELINE.md's gate, measured as tests/test_fidelity.py),
             held with retrieval off (see phase_fidelity)
  reference  small inputs at full width, the card against the CPU's plain path
  timing     one warm chain pass: seconds and audio-seconds per second

The last lines are the kernels JSON, the card's name and power limit, and
the device JSON.  Weights are random, seeded and filled by bench.py's rules
(audiolab_tpu_torch/utils/fast_init.py); widths are the published ones.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np

PHASES = ("card", "kernels", "separator", "rvc", "fidelity", "reference", "timing")
SEP_SR, RVC_SR = 44100, 16000
DUR_S = 60.0
# blend weights of the first two members of the reference's ensemble table
MEMBER_WEIGHTS = ((8.6, 16.0), (8.4, 16.0))
SEP_CFG = dict(dim=512, depth=12, heads=8, stems=("vocals",), residual_stem="other")
MEL_L1_GATE = 1e-2

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  Bounds are computed from these and this run's shapes.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    """One line for a ``-Xptxas -v`` report: kernels compiled, the range of
    registers a thread, and the kernels that spill (the full report stays
    beside the library)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", report)]
    spilled = [n for n in spills if n]
    return (f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{len(spilled)} spill (at most {max(spilled, default=0)} bytes stored)")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels

def attention_work(q, k, causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) one attention call needs: 4*d per unmasked (query, key)
    pair; q, k, v read once and o written once."""
    bh = q.shape[0] * q.shape[1]
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    if causal:
        rows = np.arange(tq)
        pairs = float(np.clip(rows + (tk - tq) + 1, 0, tk).sum())
    else:
        pairs = float(tq * tk)
    flops = 4.0 * bh * pairs * d
    nbytes = float((2 * q.numel() + 2 * k.numel()) * q.element_size())
    return flops, nbytes


def norm_work(x, params) -> tuple[float, float]:
    """(FLOPs, bytes) of one RMS/LayerNorm call: about 4 fp32 operations per
    element (5 with a bias); x read once, the output written once, the fp32
    parameters read once."""
    flops = float(x.numel() * (3 + len(params)))
    nbytes = float(2 * x.numel() * x.element_size() + sum(4 * p.numel() for p in params))
    return flops, nbytes


def check_kernel(name, kernel_fn, plain_fn, library_fn, args, shape, tol_rel, tol_reason,
                 work, peak, replaces, source="audiolab_tpu_torch/csrc/attention.cu",
                 library_note=None):
    """Holds ``kernel_fn(*args)`` against ``plain_fn(*args)`` and times both and
    the library yardstick (``library_fn`` None: there is no single call)."""
    import torch

    out = kernel_fn(*args)
    torch.cuda.synchronize()
    ref = plain_fn(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tol_rel[0] * ref.float().abs().max().item() + tol_rel[1]
    finite = bool(torch.isfinite(out).all())
    del out, ref
    ms = cuda_ms(lambda: kernel_fn(*args), iters=10)
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters=2)
    library_ms = None if library_fn is None else cuda_ms(lambda: library_fn(*args), iters=10)
    torch.cuda.empty_cache()
    flops, nbytes = work
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = dict(name=name, route="cuda", source=source, replaces=replaces, shape=shape,
               max_abs_err=err, tol=tol, tol_reason=tol_reason, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    ok = finite and err <= tol
    lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"[kernels] {name} {shape} err {err:.3e} (tol {tol:.3e}: "
        f"{tol_reason}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library {lib_txt}{f' ({library_note})' if library_note else ''} "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: err {err} > tol {tol} or non-finite")
    return rec


def attention_shape(q, k, causal):
    return dict(q=list(q.shape), k=list(k.shape), dtype=str(q.dtype), causal=causal)


def compare(label: str, fns: dict, card: str) -> None:
    """Times two ways to the same result in turns (a, b, b, a) and prints
    the means; a probe comparison, held against nothing."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(cuda_ms(fns[n], iters=10))
    txt = ", ".join(f"{n} {np.mean(runs[n]):.3f} ms ({' / '.join(f'{r:.3f}' for r in runs[n])})"
                    for n in names)
    log(f"[kernels] compare {label}: {txt} | {card}")


def phase_kernels(dev, card: str) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def sdpa(causal):
        # yardstick only: the port never calls it
        def call(q, k, v):
            mask = None
            if causal:
                tq, tk = q.shape[2], k.shape[2]
                mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return call

    k1_rep = "audiolab_tpu/kernels/attention.py:206"
    k2_rep = "audiolab_tpu/kernels/attention.py:56"
    bf = torch.bfloat16
    k1_tol = ((2.0 ** -6, 0.0), "2 bf16 ulps of max|out|: summation order may flip "
              "an output and a few probability roundings")
    k2_tol = ((0.0, 2e-5), "fp32 sums over <=512 keys in another order")
    norm_tol = ((2.0 ** -7, 0.0), "1 bf16 ulp of max|out|: fp32 row sums in another "
                "order may flip one output's rounding")
    scale = 1.0 / 8.0
    recs = []
    # (label, case, kernel, q shape, k shape, dtype, causal, on the main path)
    cases = [
        ("K1 attention_nk1 (RoFormer time axis)", "k1_time", "K1",
         (496, 8, 690, 64), (496, 8, 690, 64), bf, False, True),
        ("K1 attention_nk1 (RoFormer band axis)", "k1_band", "K1",
         (5520, 8, 62, 64), (5520, 8, 62, 64), bf, False, True),
        ("K2 flash_attention_fwd (HuBERT)", "k2_hubert", "K2",
         (8, 12, 399, 64), (8, 12, 399, 64), torch.float32, False, True),
        ("K2 flash_attention_fwd (causal, tq != tk)", "k2_causal", "K2",
         (2, 8, 100, 64), (2, 8, 333, 64), torch.float32, True, False),
    ]
    for label, key, kern, qs, ks, dt, causal, main in cases:
        q, k, v = rnd(qs, dt), rnd(ks, dt), rnd(ks, dt)
        if kern == "K1":
            rec = check_kernel(
                label, lambda q, k, v: A.attention_nk1(q, k, v),
                lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
                sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
                attention_work(q, k, False), PEAK_BF16, k1_rep)
        else:
            rec = check_kernel(
                label, lambda q, k, v, c=causal: A.flash_attention_fwd(q, k, v, causal=c),
                lambda q, k, v, c=causal: A.flash_attention_reference(q, k, v, c, scale),
                sdpa(causal), (q, k, v), attention_shape(q, k, causal), *k2_tol,
                attention_work(q, k, causal), PEAK_FP32, k2_rep)
        rec.update(case=key, kernel=kern, on_main_path=main)
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()

    # K3: the RoFormer time axis with rope fused (block_k 768 routes it here)
    time_shape = (496, 8, 690, 64)
    q, k, v = rnd(time_shape, bf), rnd(time_shape, bf), rnd(time_shape, bf)
    cos, sin = (t.to(dev) for t in A.rope_tables(690, 64))
    flops, nbytes = attention_work(q, k, False)
    rec = check_kernel(
        "K3 attention_nk1_rope (RoFormer time axis)",
        lambda q, k, v: A.flash_attention(q, k, v, block_k=768, rope_cos=cos, rope_sin=sin),
        lambda q, k, v: A.attention_nk1_rope_reference(q, k, v, cos, sin, scale),
        None, (q, k, v), attention_shape(q, k, False), *k1_tol,
        (flops, nbytes + 2 * cos.numel() * 4), PEAK_BF16,
        "audiolab_tpu/kernels/attention.py:142",
        library_note="no single PyTorch call ropes and attends")
    rec.update(case="k3_time", kernel="K3", on_main_path=False)
    recs.append(rec)
    compare("K3 fused rope vs apply_rope_tables + K1 (time axis)", {
        "K3": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "rope+K1": lambda: A.attention_nk1(A.apply_rope_tables(q, cos, sin),
                                           A.apply_rope_tables(k, cos, sin), v),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()

    # K7: the time axis read straight from a fused (b, t, 3*h*d) qkv activation
    b, t, h, d = 496, 690, 8, 64
    inner = h * d
    qkv = rnd((b, t, 3 * inner), bf)
    q, k, v = (x.contiguous() for x in qkv.split(inner, dim=-1))
    flops, nbytes = attention_work(q.view(b, t, h, d).transpose(1, 2),
                                   k.view(b, t, h, d).transpose(1, 2), False)

    def heads_first(x):
        return x.view(b, t, h, d).transpose(1, 2)

    rec = check_kernel(
        "K7 packed_attention (RoFormer time axis, packed)",
        lambda q, k, v: A.packed_attention(q, k, v, h, d),
        lambda q, k, v: A.packed_attention_reference(q, k, v, h, d, scale),
        lambda q, k, v: F.scaled_dot_product_attention(heads_first(q), heads_first(k),
                                                       heads_first(v)),
        (q, k, v), dict(q=list(q.shape), heads=h, dim_head=d, dtype=str(q.dtype)), *k1_tol,
        (flops, nbytes), PEAK_BF16, "tools/probe_packed_attn.py:68")
    rec.update(case="k7_time", kernel="K7", on_main_path=False)
    recs.append(rec)
    del q, k, v
    qs, ks, vs = qkv.split(inner, dim=-1)

    def split_transpose_k1():
        o = A.attention_nk1(heads_first(qs).contiguous(), heads_first(ks).contiguous(),
                            heads_first(vs).contiguous())
        return o.transpose(1, 2).reshape(b, t, inner)

    compare("K7 on the fused qkv's views vs split + 3 transposes + K1 + transpose back", {
        "K7": lambda: A.packed_attention(qs, ks, vs, h, d),
        "split+K1": split_transpose_k1,
    }, card)
    del qkv, qs, ks, vs
    torch.cuda.empty_cache()

    # K6: the band axis
    band_shape = (5520, 8, 62, 64)
    q, k, v = rnd(band_shape, bf), rnd(band_shape, bf), rnd(band_shape, bf)
    rec = check_kernel(
        "K6 slim_attention (RoFormer band axis)",
        lambda q, k, v: A.slim_attention(q, k, v),
        lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
        sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
        attention_work(q, k, False), PEAK_BF16, "tools/probe_freq_bh128.py:36")
    rec.update(case="k6_band", kernel="K6", on_main_path=False)
    recs.append(rec)
    compare("K6 vs K1 (band axis)", {
        "K6": lambda: A.slim_attention(q, k, v),
        "K1": lambda: A.attention_nk1(q, k, v),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()

    # K4, K5: the RoFormer's time-axis activation, 8 chunks x 62 bands x 690
    # frames at dim 512
    x = rnd((8 * 62 * 690, 512), bf)
    w = 1.0 + 0.1 * rnd((512,), torch.float32)
    bias = 0.1 * rnd((512,), torch.float32)
    w_lib, b_lib = w.to(bf), bias.to(bf)
    norm_shape = dict(x=list(x.shape), dtype=str(x.dtype), params="float32")
    rec = check_kernel(
        "K4 rms_norm (RoFormer time-axis activation)",
        lambda x, w: N.rms_norm(x, w), lambda x, w: N.rms_norm_reference(x, w),
        lambda x, w: F.rms_norm(x, (512,), w_lib, 1e-5), (x, w), norm_shape, *norm_tol,
        norm_work(x, (w,)), PEAK_FP32, "audiolab_tpu/kernels/norms.py:30",
        source="audiolab_tpu_torch/csrc/norms.cu",
        library_note="weight in bf16: F.rms_norm's fused path needs the input's type")
    rec.update(case="k4_time", kernel="K4", on_main_path=False)
    recs.append(rec)
    rec = check_kernel(
        "K5 layer_norm (RoFormer time-axis activation)",
        lambda x, w, bias: N.layer_norm(x, w, bias),
        lambda x, w, bias: N.layer_norm_reference(x, w, bias),
        lambda x, w, bias: F.layer_norm(x, (512,), w_lib, b_lib, 1e-5), (x, w, bias),
        norm_shape, *norm_tol, norm_work(x, (w, bias)), PEAK_FP32,
        "audiolab_tpu/kernels/norms.py:38", source="audiolab_tpu_torch/csrc/norms.cu",
        library_note="weight and bias in bf16: F.layer_norm needs the input's type")
    rec.update(case="k5_time", kernel="K5", on_main_path=False)
    recs.append(rec)
    del x
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------- models

def build_separator(dev, cfg_kw=SEP_CFG, sr=SEP_SR, chunk_s=8.0, overlap_s=0.5):
    """Two BS-RoFormer members with distinct seeded weights, made on ``dev``
    and filled by bench.py's rules (utils/fast_init.py)."""
    import torch

    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
    from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cfg = RoformerConfig(**cfg_kw)
    members = []
    for i, (wv, wi) in enumerate(MEMBER_WEIGHTS):
        with torch.device(dev):
            model = fast_init(BSRoformer(cfg), seed=100 + i)
        members.append(EnsembleMember(f"bs_roformer_{i}", model, wv, wi))
    return StemSeparator(members, sr=sr, chunk_seconds=chunk_s, overlap_seconds=overlap_s,
                         device_batch=8, device=dev)


def build_rvc(dev, synth_kw=None, hubert_kw=None, rmvpe_kw=None, index_rows=4096,
              index_dim=768, rvc_kw=None):
    """v2-48k synthesizer, HuBERT, RMVPE (bf16 U-Net) and a seeded index,
    wrapped twice: under the bf16 matmul policy (the default) and under fp32.
    Weights are filled by bench.py's rules (utils/fast_init.py)."""
    import torch

    from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.rvc.synthesizer import (
        SynthesizerConfig,
        SynthesizerTrn,
        config_for,
    )
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        synth = SynthesizerTrn(SynthesizerConfig(**synth_kw) if synth_kw
                               else config_for(48000, "v2"))
        hubert = HubertFeatureExtractor("v2", HubertConfig(**(hubert_kw or {})))
        rmvpe = RMVPE(**(rmvpe_kw or {}))
    for seed, module in enumerate((synth, hubert, rmvpe)):
        fast_init(module, seed)
    index = np.random.default_rng(0).standard_normal((index_rows, index_dim)).astype(np.float32)
    kw = dict(sr=48000, f0_method="rmvpe", **(rvc_kw or {}))
    return {prec: VoiceConverter(synth, hubert, rmvpe, index_features=index, device=dev,
                                 cfg=RVCPipelineConfig(matmul_precision=prec, **kw))
            for prec in ("bfloat16", "highest")}


def to_rvc_input(vocals):
    """Device mono mix and 44.1 -> 16 kHz polyphase resample."""
    from audiolab_tpu_torch.kernels.resample import resample

    return resample(vocals.mean(dim=0), SEP_SR, RVC_SR)


def mel_l1(a, b, sr: int) -> float:
    """tests/test_fidelity.py's measure: mean |log-mel difference|."""
    from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram

    n = min(a.shape[-1], b.shape[-1])
    ma = log_mel(mel_spectrogram(a[..., :n].float()[None], sr=sr, n_fft=1024, hop=256,
                                 n_mels=80, power=1.0))
    mb = log_mel(mel_spectrogram(b[..., :n].float()[None], sr=sr, n_fft=1024, hop=256,
                                 n_mels=80, power=1.0))
    return float((ma - mb).abs().mean())


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def counts() -> dict[str, int]:
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    return {"K1": A.attention_nk1.launches, "K2": A.flash_attention_fwd.launches,
            "K3": A.attention_nk1_rope.launches, "K4": N.rms_norm.launches,
            "K5": N.layer_norm.launches, "K6": A.slim_attention.launches,
            "K7": A.packed_attention.launches}


def reset_counts() -> None:
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    A.reset_launch_counts()
    N.reset_launch_counts()


def only(launches: dict, kernel: str, n: int) -> bool:
    """``kernel`` launched n times and every other kernel not at all."""
    return all(launches[k] == (n if k == kernel else 0) for k in KERNELS)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_separator(dev, sep, audio, expect_k1: int | None = 48) -> tuple[dict, dict, float]:
    """Main path, part 1: counts reset just before, read just after."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    stems = sep.separate(audio, as_numpy=False)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = counts()
    n = audio.shape[-1]
    ok_shape = all(tuple(v.shape) == (2, n) for v in stems.values())
    finite = all(bool(torch.isfinite(v).all()) for v in stems.values())
    log(f"[separator] 2 members x {sep.members[0].apply_fn.cfg.depth} axial pairs, "
        f"dim {sep.members[0].apply_fn.cfg.dim}, {n / SEP_SR:.1f} s stereo: "
        f"stems {sorted(stems)} shapes {[tuple(v.shape) for v in stems.values()]} "
        f"finite {finite} launches {launches} {secs:.3f} s")
    expect(ok_shape and finite, "separator: stem shape or finiteness")
    expect(set(stems) == {"vocals", "instrumental"}, "separator: stems")
    if expect_k1 is not None:
        expect(only(launches, "K1", expect_k1),
               f"separator: launches {launches}, expected K1 {expect_k1} and no other")
    return stems, launches, secs


def phase_rvc(dev, vc, vocals, expect_k2: int | None = 12) -> tuple[object, object, dict, float]:
    """Main path, part 2: counts reset just before, read just after."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    x16 = to_rvc_input(vocals)
    out = vc.convert(x16, sid=0, seed=0, as_numpy=False)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = counts()
    n_out = int(round(x16.shape[-1] * vc.synth_cfg.sr / RVC_SR))
    finite = bool(torch.isfinite(out).all())
    log(f"[rvc] {x16.shape[-1] / RVC_SR:.1f} s at 16 kHz -> {tuple(out.shape)} at "
        f"{vc.synth_cfg.sr} Hz (expected {n_out}) finite {finite} peak "
        f"{float(out.abs().max()):.4f} launches {launches} {secs:.3f} s")
    expect(tuple(out.shape) == (n_out,) and finite, "rvc: output length or finiteness")
    if expect_k2 is not None:
        expect(only(launches, "K2", expect_k2),
               f"rvc: launches {launches}, expected K2 {expect_k2} and no other")
    return x16, out, launches, secs


def phase_fidelity(dev, vcs, x16, out_bf16) -> float:
    """bf16 matmul policy against fp32 on the same input, RMVPE and noise.
    The gate is held with retrieval off: against a random index every
    query's neighbours are near-ties, so any change to the features (bf16
    rounding, or fp32 sums in another order) swaps some of the 8 neighbours
    and the blended features jump.  The chain's own setting (retrieval at
    0.75) is printed beside it."""
    t0 = time.perf_counter()
    sr = vcs["highest"].synth_cfg.sr
    chain32 = vcs["highest"].convert(x16, sid=0, seed=0, as_numpy=False)
    chain_err = mel_l1(out_bf16, chain32, sr)
    off = {p: vcs[p].convert(x16, sid=0, seed=0, index_rate=0.0, as_numpy=False)
           for p in ("bfloat16", "highest")}
    sync(dev)
    err = mel_l1(off["bfloat16"], off["highest"], sr)
    mx = float((off["bfloat16"] - off["highest"]).abs().max())
    log(f"[fidelity] bf16 policy vs fp32, same input/RMVPE/noise, retrieval off: "
        f"mel-L1 {err:.6f} (gate < {MEL_L1_GATE}) max|diff| {mx:.3e} peak "
        f"{float(off['highest'].abs().max()):.4f}; with the chain's retrieval (0.75, "
        f"random index, not gated): mel-L1 {chain_err:.6f}; "
        f"{time.perf_counter() - t0:.3f} s {'OK' if err < MEL_L1_GATE else 'FAIL'}")
    expect(err < MEL_L1_GATE, f"fidelity: mel-L1 {err} >= {MEL_L1_GATE}")
    return err


def phase_reference(dev, sep, vcs) -> None:
    """Full-width modules on short inputs, the card against the CPU's plain
    path, fp32 (attention then runs K2 on the card; K1's numerics are held
    against its plain version in the kernels phase)."""
    import copy

    import torch

    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig

    cpu = torch.device("cpu")
    member = sep.members[0].apply_fn
    cfg32 = RoformerConfig(**{**member.cfg.__dict__, "dtype": "float32"})
    sd = {k: v.detach().cpu() for k, v in member.state_dict().items()}
    models = {}
    for d in (dev, cpu):
        with torch.device(d):
            m = BSRoformer(cfg32)
        m.load_state_dict(sd)
        models[d.type] = m.eval()
    x = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal(
        (1, 2, SEP_SR))).astype(np.float32))
    with torch.inference_mode():
        got = models[dev.type](x.to(dev))["vocals"].cpu()
        ref = models["cpu"](x)["vocals"]
    err = float((got - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    log(f"[reference] BS-RoFormer member fp32, 1 s stereo, card vs CPU: max|diff| "
        f"{err:.3e} (tol {tol:.3e}: 1e-3 of max|vocals|, fp32 sums in another order "
        f"through 24 transformer blocks) {'OK' if err <= tol else 'FAIL'}")
    expect(err <= tol, "reference: separator member card vs CPU")
    del models

    hub = vcs["highest"].hubert
    hub_cpu = copy.deepcopy(hub).to(cpu)
    wav = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal(
        (2, RVC_SR * 2))).astype(np.float32))
    with torch.inference_mode():
        got = hub(wav.to(dev)).cpu()
        ref = hub_cpu(wav)
    err = float((got - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    log(f"[reference] HuBERT fp32 (K2 attention), 2 x 2 s, card vs CPU: max|diff| "
        f"{err:.3e} (tol {tol:.3e}: 1e-3 of max|features|, fp32 sums in another order "
        f"through 12 post-LN layers) {'OK' if err <= tol else 'FAIL'}")
    expect(err <= tol, "reference: HuBERT card vs CPU")


def phase_timing(dev, sep, vc, audio, card: str, profile_dir: str | None) -> dict:
    import torch

    def chain():
        t0 = time.perf_counter()
        stems = sep.separate(audio, as_numpy=False)
        sync(dev)
        t1 = time.perf_counter()
        out = vc.convert(to_rvc_input(stems["vocals"]), sid=0, seed=0, as_numpy=False)
        sync(dev)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, out

    torch.cuda.reset_peak_memory_stats()
    t_sep, t_rvc, _ = chain()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total = t_sep + t_rvc
    dur = audio.shape[-1] / SEP_SR
    rec = dict(sep_s=t_sep, rvc_s=t_rvc, chain_s=total, audio_s_per_s=dur / total,
               peak_mem_gb=peak_gb, card=card)
    log(f"[timing] warm chain on {dur:.1f} s: separate {t_sep:.3f} s, rvc {t_rvc:.3f} s, "
        f"chain {total:.3f} s = {dur / total:.3f} audio-s/s, peak memory "
        f"{peak_gb:.2f} GB | {card}")
    if profile_dir:
        from pathlib import Path

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chain()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        path = Path(profile_dir) / "chip_smoke_profile.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"{card}\n{table}\n")
        log(f"[timing] profiler table of one chain pass -> {path}")
    return rec


# ---------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", default=None, help="directory for a profiler table")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2

    from audiolab_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = _build.build(["attention", "norms"])
    build_s = time.perf_counter() - t0
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| kernel build {build_s:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log")
        if report.exists():
            log(f"[card] ptxas {name}: {ptxas_summary(report.read_text())} ({report})")

    kernel_recs: list[dict] = []
    if "kernels" in phases:
        kernel_recs = phase_kernels(dev, card)

    main_launches = dict.fromkeys(KERNELS, 0)
    need_chain = {"separator", "rvc", "fidelity", "reference", "timing"} & set(phases)
    if need_chain:
        t0 = time.perf_counter()
        sep = build_separator(dev)
        vcs = build_rvc(dev)
        sync(dev)
        log(f"[card] models built on the card in {time.perf_counter() - t0:.1f} s")
        audio = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
            (2, int(DUR_S * SEP_SR)))).astype(np.float32)).to(dev)
        stems, launches, _ = phase_separator(dev, sep, audio)
        for k in main_launches:
            main_launches[k] += launches[k]
        x16, out, launches, _ = phase_rvc(dev, vcs["bfloat16"], stems["vocals"])
        for k in main_launches:
            main_launches[k] += launches[k]
        if "fidelity" in phases:
            phase_fidelity(dev, vcs, x16, out)
        del stems, x16, out
        if "reference" in phases:
            phase_reference(dev, sep, vcs)
        if "timing" in phases:
            phase_timing(dev, sep, vcs["bfloat16"], audio, card, args.profile)

    log(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"launches": main_launches[r["kernel"]], "case": r["case"],
           "on_main_path": r["on_main_path"]}
        for r in kernel_recs]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
