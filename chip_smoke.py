"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main path's shapes,
drives the separate -> RVC chain at full width, and checks the output.

    python3 chip_smoke.py                          # every phase, one card
    python3 chip_smoke.py --phases card,kernels    # a subset
    python3 chip_smoke.py --phases card,f0,vr,long # the paths beside the chain
    python3 chip_smoke.py --profile DIR            # + a profiler table of one chain pass

Phases, one line each (any failure exits non-zero, and no result is printed):

  card       nvidia-smi name and power limit, torch/CUDA versions, build seconds
  kernels    K1 and K2 against their plain versions at the main path's shapes
             (K2 in fp32 and in bf16), K1's Hopper design against the WMMA core
             on each axis (in turns); the 16-bit K2 on its Hopper design at
             the HuBERT shape, a causal tq != tk shape, a causal language-model
             prefill (16 x 2048 x 128) and a d = 128 shape with ragged keys,
             each against the row-per-thread-group kernel in turns; K3-K7 (off
             the chain) against theirs at the RoFormer's shapes: K3 on the rope
             variant of the Hopper time design against its WMMA core, K7 on
             the packed layout and on a fused qkv's views, K6 and K7 each
             against its WMMA core and against K1's route of the same shape,
             and the three comparisons the TPU probes were written for
  separator  two BS-RoFormer members (dim 512, 12 axial pairs, 8 heads x 64,
             distinct seeded weights) on a 60 s stereo 44.1 kHz track: 8 chunks,
             one device batch; 48 K1 launches, all on the Hopper routes
  rvc        mono mix, 44.1 -> 16 kHz, VoiceConverter.convert at v2-48k with full
             HuBERT, full RMVPE and a 4096 x 768 index; 12 K2 launches
  fidelity   the same RVC input under the fp32 and the bf16 matmul policy:
             mel-L1 < 1e-2 (BASELINE.md's gate, measured as tests/test_fidelity.py),
             held with retrieval off (see phase_fidelity); the policy's
             convolutions against fp64 (stops above 1e-4 of max|y|), and the
             RVC seconds and mel-L1 with them run two other ways
  f0         convert on the separator's vocals with the f0 methods beside rmvpe:
             YIN fused into the conversion (no RMVPE), rmvpe+, and the hybrid
             ["harvest", "rmvpe+"] (harvest on the host, timed apart); 12 K2
             launches a group each
  reference  small inputs at full width, the card against the CPU's plain path
  timing     one warm chain pass: seconds and audio-seconds per second, and two
             more passes for the spread
  vr         the VR karaoke split (vr_split, KARAOKE) on the stereo vocals stem:
             CascadedASPPNet on 4band_v3 and CascadedNet on 1band_sr44100_hl512
             at VRConfig's default widths, window 512; primary + complement
             against the band round trip of the input, one forward on the card
             against the CPU, seconds for the 60 s stem
  long       bench.py's 4-minute track through separate -> mono -> resample ->
             convert, once after a pass that warms its shapes: 32 chunks in 4
             groups of 8, 192 K1 launches (all Hopper), 48 K2, stage seconds

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

PHASES = ("card", "kernels", "separator", "rvc", "fidelity", "f0", "reference", "timing", "vr",
          "long")
SEP_SR, RVC_SR = 44100, 16000
DUR_S = 60.0
LONG_S = 240.0     # bench.py's 4-minute track
HUBERT_LAYERS = 12
# blend weights of the first two members of the reference's ensemble table
MEMBER_WEIGHTS = ((8.6, 16.0), (8.4, 16.0))
SEP_CFG = dict(dim=512, depth=12, heads=8, stems=("vocals",), residual_stem="other")
MEL_L1_GATE = 1e-2

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  Bounds are computed from these and this run's shapes.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exponentials a second on the SFUs (MUFU), as the FlashAttention-3 paper
# gives it for H100 SXM
PEAK_EXP = 3.9e12


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


def ptxas_kernels(report: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers a thread, spill-store bytes) of each entry
    in a ``-Xptxas -v`` report."""
    out = []
    for part in report.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0))
    return out


# setmaxnreg hands the producer warpgroup's registers to the two consumer
# warpgroups (168 -> 40 and 168 -> 232 a thread), which needs the launch to
# hold 384 x 168 registers: the __launch_bounds__(384, 1) maximum
K1H_LAUNCH_REGS = 168


def check_new_kernels(report: str) -> None:
    """One line per kernel of this design (the Hopper routes of K1, K3, K6
    and K7, all ``k1h_`` kernels, K2's Hopper kernel ``k2h_`` and its fp32
    kernel) with its registers and spills; raises before any launch if a
    ``k1h_`` or ``k2h_`` kernel would start with fewer registers than
    setmaxnreg hands out, or if ptxas serialised a kernel's wgmma (C7515)."""
    for name, regs, spill in ptxas_kernels(report):
        if not any(tag in name for tag in ("k1h_", "k2h_", "k2f_")):
            continue
        log(f"[card] ptxas {name}: {regs} registers, {spill} bytes spill stores")
        if "k1h_" in name or "k2h_" in name:
            expect(regs == K1H_LAUNCH_REGS,
                   f"{name}: {regs} registers at launch, setmaxnreg needs {K1H_LAUNCH_REGS}")
    expect("C7515" not in report, "ptxas serialised a kernel's wgmma instructions (C7515)")


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

def attention_work(q, k, causal: bool) -> tuple[float, float, float]:
    """(FLOPs, bytes, exponentials) one attention call needs: 4*d FLOPs and
    one exponential per unmasked (query, key) pair; q, k, v read once and o
    written once."""
    bh = q.shape[0] * q.shape[1]
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    if causal:
        rows = np.arange(tq)
        pairs = float(np.clip(rows + (tk - tq) + 1, 0, tk).sum())
    else:
        pairs = float(tq * tk)
    flops = 4.0 * bh * pairs * d
    nbytes = float((2 * q.numel() + 2 * k.numel()) * q.element_size())
    return flops, nbytes, float(bh * pairs)


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
    # three warm-up calls: the first kernel timed after the build ran ~15 %
    # slow after a single one (the card still ramping its clocks)
    ms = cuda_ms(lambda: kernel_fn(*args), iters=10, warmup=3)
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters=2)
    library_ms = None if library_fn is None else cuda_ms(lambda: library_fn(*args), iters=10)
    torch.cuda.empty_cache()
    flops, nbytes, exps = (*work, 0.0)[:3]
    t_ops, t_bytes, t_exp = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3, exps / PEAK_EXP * 1e3
    rec = dict(name=name, route="cuda", source=source, replaces=replaces, shape=shape,
               max_abs_err=err, tol=tol, tol_reason=tol_reason, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes, t_exp),
               bound_by="operations" if max(t_ops, t_exp) >= t_bytes else "bytes",
               bound_parts_ms=dict(products=t_ops, exponentials=t_exp, bytes=t_bytes),
               flops=flops, bytes=nbytes, exponentials=exps)
    ok = finite and err <= tol
    lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"[kernels] {name} {shape} err {err:.3e} (tol {tol:.3e}: "
        f"{tol_reason}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library {lib_txt}{f' ({library_note})' if library_note else ''} "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: products {t_ops:.3f}, "
        f"exponentials {t_exp:.3f}, bytes {t_bytes:.3f}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: err {err} > tol {tol} or non-finite")
    return rec


def attention_shape(q, k, causal):
    return dict(q=list(q.shape), k=list(k.shape), dtype=str(q.dtype), causal=causal)


def compare(label: str, fns: dict, card: str) -> dict[str, float]:
    """Times two ways to the same result in turns (a, b, b, a), prints and
    returns the means; a comparison held against nothing."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(cuda_ms(fns[n], iters=10))
    txt = ", ".join(f"{n} {np.mean(runs[n]):.3f} ms ({' / '.join(f'{r:.3f}' for r in runs[n])})"
                    for n in names)
    log(f"[kernels] compare {label}: {txt} | {card}")
    return {n: float(np.mean(runs[n])) for n in names}


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
            tq, tk = q.shape[2], k.shape[2]
            if causal and tq == tk:     # its fused causal kernel takes no offset
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
            mask = None
            if causal:
                mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return call

    def hopper_launches(fn, wrapper):
        before = wrapper.sm90_launches
        fn()
        return wrapper.sm90_launches - before

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
        ("K2 flash_attention_fwd (HuBERT shape, bf16)", "k2_hubert_bf16", "K2",
         (8, 12, 399, 64), (8, 12, 399, 64), bf, False, False),
        ("K2 flash_attention_fwd (causal, tq != tk, bf16)", "k2_causal_bf16", "K2",
         (2, 8, 100, 64), (2, 8, 333, 64), bf, True, False),
        # the width and a prefill length of the JAX package's language model
        ("K2 flash_attention_fwd (causal LM prefill, d = 128, bf16)", "k2_lm_prefill_bf16", "K2",
         (1, 16, 2048, 128), (1, 16, 2048, 128), bf, True, False),
        ("K2 flash_attention_fwd (d = 128, ragged keys, bf16)", "k2_d128_ragged_bf16", "K2",
         (2, 16, 1000, 128), (2, 16, 1537, 128), bf, False, False),
    ]
    for label, key, kern, qs, ks, dt, causal, main in cases:
        q, k, v = rnd(qs, dt), rnd(ks, dt), rnd(ks, dt)
        if kern == "K1":
            rec = check_kernel(
                label, lambda q, k, v: A.attention_nk1(q, k, v),
                lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
                sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
                attention_work(q, k, False), PEAK_BF16, k1_rep)
            route = A.k1_route(qs[0] * qs[1], qs[2], ks[2], qs[3], dt)
            expect(route in ("band", "time"), f"{label}: routed to {route}")
            # the WMMA core through its own entry, as a yardstick only
            means = compare(f"K1 Hopper {route} route vs WMMA core ({key})", {
                "hopper": lambda: A.attention_nk1(q, k, v),
                "core": lambda: A.attention_nk1_core(q, k, v),
            }, card)
            rec.update(k1_route=route, core_ms=means["core"], compare_hopper_ms=means["hopper"])
        else:
            rec = check_kernel(
                label, lambda q, k, v, c=causal: A.flash_attention_fwd(q, k, v, causal=c),
                lambda q, k, v, c=causal: A.flash_attention_reference(q, k, v, c,
                                                                      q.shape[-1] ** -0.5),
                sdpa(causal), (q, k, v), attention_shape(q, k, causal),
                *(k2_tol if dt == torch.float32 else k1_tol),
                attention_work(q, k, causal), PEAK_FP32 if dt == torch.float32 else PEAK_BF16,
                k2_rep)
            if dt != torch.float32:
                route = A.k2_route(qs[0] * qs[1], qs[2], ks[2], qs[3], dt, causal, True)
                expect(route == "sm90", f"{label}: routed to {route}")
                expect(hopper_launches(lambda: A.flash_attention_fwd(q, k, v, causal=causal),
                                       A.flash_attention_fwd) == 1,
                       f"{label}: the launch was not on the Hopper design")
                # the row-per-thread-group kernel through its own entry, as a yardstick only
                means = compare(f"K2 Hopper design vs row-per-thread-group kernel ({key})", {
                    "hopper": lambda: A.flash_attention_fwd(q, k, v, causal=causal),
                    "core": lambda: A.flash_attention_fwd_core(q, k, v, causal=causal),
                }, card)
                rec.update(k2_route=route, core_ms=means["core"],
                           compare_hopper_ms=means["hopper"])
        rec.update(case=key, kernel=kern, on_main_path=main)
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()

    # long sequences, where every CTA pulls a slice's K and V from L2 again for
    # its 128 query rows: the 16-bit K2 beside SDPA, timed only
    for d in (64, 128):
        q, k, v = (rnd((4, 16, 4096, d), bf) for _ in range(3))
        compare(f"K2 Hopper design vs SDPA, 64 x 4096 x 4096 x {d} bf16, not causal", {
            "K2": lambda: A.flash_attention_fwd(q, k, v),
            "SDPA": lambda: F.scaled_dot_product_attention(q, k, v),
        }, card)
        del q, k, v
        torch.cuda.empty_cache()
    # a decode step (one query row): k2_route keeps it on the Hopper design
    q, k, v = rnd((1, 16, 1, 128), bf), rnd((1, 16, 2048, 128), bf), rnd((1, 16, 2048, 128), bf)
    compare("K2 Hopper design vs row-per-thread-group kernel, decode step 16 x 1/2048 x 128", {
        "hopper": lambda: A.flash_attention_fwd(q, k, v, causal=True),
        "core": lambda: A.flash_attention_fwd_core(q, k, v, causal=True),
    }, card)
    del q, k, v

    # K3: the RoFormer time axis with rope fused (block_k 768 routes it here)
    time_shape = (496, 8, 690, 64)
    q, k, v = rnd(time_shape, bf), rnd(time_shape, bf), rnd(time_shape, bf)
    cos, sin = (t.to(dev) for t in A.rope_tables(690, 64))
    flops, nbytes, exps = attention_work(q, k, False)
    rec = check_kernel(
        "K3 attention_nk1_rope (RoFormer time axis)",
        lambda q, k, v: A.flash_attention(q, k, v, block_k=768, rope_cos=cos, rope_sin=sin),
        lambda q, k, v: A.attention_nk1_rope_reference(q, k, v, cos, sin, scale),
        None, (q, k, v), attention_shape(q, k, False), *k1_tol,
        (flops, nbytes + 2 * cos.numel() * 4, exps), PEAK_BF16,
        "audiolab_tpu/kernels/attention.py:142",
        library_note="no single PyTorch call ropes and attends")
    route = A.k3_route(time_shape[0] * time_shape[1], 690, 690, 64, bf, True)
    expect(route == "time", f"K3: routed to {route}")
    expect(hopper_launches(lambda: A.attention_nk1_rope(q, k, v, cos, sin),
                           A.attention_nk1_rope) == 1,
           "K3: the launch was not on the Hopper design")
    means = compare("K3 Hopper time route vs WMMA core", {
        "hopper": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "core": lambda: A.attention_nk1_rope_core(q, k, v, cos, sin),
    }, card)
    rec.update(case="k3_time", kernel="K3", on_main_path=False, k3_route=route,
               core_ms=means["core"], compare_hopper_ms=means["hopper"])
    recs.append(rec)
    compare("K3 fused rope vs apply_rope_tables + K1 (time axis)", {
        "K3": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "rope+K1": lambda: A.attention_nk1(A.apply_rope_tables(q, cos, sin),
                                           A.apply_rope_tables(k, cos, sin), v),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()
    # a band-shaped call: k3_route sends it to the time design over one chunk
    band_shape = (5520, 8, 62, 64)
    q, k, v = rnd(band_shape, bf), rnd(band_shape, bf), rnd(band_shape, bf)
    compare("K3 Hopper time route (one chunk) vs WMMA core (band axis)", {
        "hopper": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "core": lambda: A.attention_nk1_rope_core(q, k, v, cos, sin),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()

    # K7: the time axis in the packed (b, t, h*d) layout, contiguous and read
    # straight from a fused (b, t, 3*h*d) qkv activation
    b, t, h, d = 496, 690, 8, 64
    inner = h * d
    qkv = rnd((b, t, 3 * inner), bf)

    def heads_first(x):
        return x.view(b, t, h, d).transpose(1, 2)

    k7_recs = {}
    for layout in ("packed", "qkv views"):
        q, k, v = qkv.split(inner, dim=-1)
        if layout == "packed":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        route = A.k7_route(b, h, t, d, q.stride(1), bf, True)
        expect(route == "time", f"K7 ({layout}): routed to {route}")
        expect(hopper_launches(lambda: A.packed_attention(q, k, v, h, d),
                               A.packed_attention) == 1,
               f"K7 ({layout}): the launch was not on the Hopper design")
        rec = check_kernel(
            f"K7 packed_attention (RoFormer time axis, {layout})",
            lambda q, k, v: A.packed_attention(q, k, v, h, d),
            lambda q, k, v: A.packed_attention_reference(q, k, v, h, d, scale),
            lambda q, k, v: F.scaled_dot_product_attention(heads_first(q), heads_first(k),
                                                           heads_first(v)),
            (q, k, v), dict(q=list(q.shape), row_stride=q.stride(1), heads=h, dim_head=d,
                            dtype=str(q.dtype)), *k1_tol,
            attention_work(heads_first(q), heads_first(k), False), PEAK_BF16,
            "tools/probe_packed_attn.py:68")
        means = compare(f"K7 Hopper time route vs WMMA core ({layout})", {
            "hopper": lambda: A.packed_attention(q, k, v, h, d),
            "core": lambda: A.packed_attention_core(q, k, v, h, d),
        }, card)
        rec.update(case="k7_time" if layout == "packed" else "k7_time_views", kernel="K7",
                   on_main_path=False, k7_route=route, core_ms=means["core"],
                   compare_hopper_ms=means["hopper"])
        recs.append(rec)
        k7_recs[layout] = (q, k, v)
    qp, kp, vp = k7_recs["packed"]
    qs, ks, vs = k7_recs["qkv views"]
    q1, k1, v1 = (heads_first(x).contiguous() for x in (qp, kp, vp))
    del k7_recs

    def split_transpose_k1():
        o = A.attention_nk1(heads_first(qs).contiguous(), heads_first(ks).contiguous(),
                            heads_first(vs).contiguous())
        return o.transpose(1, 2).reshape(b, t, inner)

    compare("K7 on each layout vs K1's time route on the same slices", {
        "K7 packed": lambda: A.packed_attention(qp, kp, vp, h, d),
        "K7 qkv views": lambda: A.packed_attention(qs, ks, vs, h, d),
        "K1": lambda: A.attention_nk1(q1, k1, v1),
    }, card)
    del q1, k1, v1, qp, kp, vp
    compare("K7 on the fused qkv's views vs split + 3 transposes + K1 + transpose back", {
        "K7": lambda: A.packed_attention(qs, ks, vs, h, d),
        "split+K1": split_transpose_k1,
    }, card)
    del qkv, qs, ks, vs
    torch.cuda.empty_cache()

    # K6: the band axis
    band_shape = (5520, 8, 62, 64)
    q, k, v = rnd(band_shape, bf), rnd(band_shape, bf), rnd(band_shape, bf)
    route = A.k6_route(band_shape[0] * band_shape[1], 62, 62, 64, bf, True)
    expect(route == "band", f"K6: routed to {route}")
    expect(hopper_launches(lambda: A.slim_attention(q, k, v), A.slim_attention) == 1,
           "K6: the launch was not on the Hopper design")
    rec = check_kernel(
        "K6 slim_attention (RoFormer band axis)",
        lambda q, k, v: A.slim_attention(q, k, v),
        lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
        sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
        attention_work(q, k, False), PEAK_BF16, "tools/probe_freq_bh128.py:36")
    means = compare("K6 Hopper band route vs WMMA core", {
        "hopper": lambda: A.slim_attention(q, k, v),
        "core": lambda: A.slim_attention_core(q, k, v),
    }, card)
    rec.update(case="k6_band", kernel="K6", on_main_path=False, k6_route=route,
               core_ms=means["core"], compare_hopper_ms=means["hopper"])
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

    from audiolab_tpu_torch.kernels import attention as A

    reset_counts()
    t0 = time.perf_counter()
    stems = sep.separate(audio, as_numpy=False)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = counts()
    k1_hopper = A.attention_nk1.sm90_launches
    n = audio.shape[-1]
    ok_shape = all(tuple(v.shape) == (2, n) for v in stems.values())
    finite = all(bool(torch.isfinite(v).all()) for v in stems.values())
    log(f"[separator] 2 members x {sep.members[0].apply_fn.cfg.depth} axial pairs, "
        f"dim {sep.members[0].apply_fn.cfg.dim}, {n / SEP_SR:.1f} s stereo: "
        f"stems {sorted(stems)} shapes {[tuple(v.shape) for v in stems.values()]} "
        f"finite {finite} launches {launches} (K1 on the Hopper routes: {k1_hopper}) "
        f"{secs:.3f} s")
    expect(ok_shape and finite, "separator: stem shape or finiteness")
    expect(set(stems) == {"vocals", "instrumental"}, "separator: stems")
    if expect_k1 is not None:
        expect(only(launches, "K1", expect_k1),
               f"separator: launches {launches}, expected K1 {expect_k1} and no other")
        expect(k1_hopper == expect_k1,
               f"separator: {k1_hopper} of {launches['K1']} K1 launches on the Hopper routes")
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
    phase_conv_policy(dev, vcs, x16, off["highest"], chain32)
    return err


def phase_conv_policy(dev, vcs, x16, ref_off, ref_on) -> None:
    """The policy's convolutions (TF32 cuDNN on bf16-rounded operands)
    against the two other ways to run them: the fp32 call with TF32 off
    (the same function, on the CUDA cores) and the bf16 call, whose result
    is rounded to bf16 (the policy's earlier form).  One convolution at the NSF
    decoder's first shape against fp64 on the rounded operands, then the
    RVC stage's seconds in turns and its mel-L1 against fp32 each way."""
    import torch
    import torch.nn.functional as F

    from audiolab_tpu_torch.core import precision as P

    port = P._conv
    ways = {
        "tf32 on rounded operands (the port's)": port,
        "fp32, TF32 off": lambda fn, x, w, *a: fn(P._round(x), P._round(w), None, *a),
        "bf16 call, result rounded": lambda fn, x, w, *a: fn(
            x.bfloat16(), w.bfloat16(), None, *a).float(),
    }
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 512, 12000, device=dev, generator=g)
    w = 0.05 * torch.randn(256, 512, 7, device=dev, generator=g)
    ref = F.conv1d(P._round(x).double(), P._round(w).double(), padding=3)
    vc = vcs["bfloat16"]
    sr = vc.synth_cfg.sr
    res = {}
    try:
        for name, conv in ways.items():
            P._conv = conv
            with P.matmul_precision("bfloat16"):
                y = P.conv1d(x, w, None, 1, 3)
                rel = float((y.double() - ref).abs().max() / ref.abs().max())
                ms = cuda_ms(lambda: P.conv1d(x, w, None, 1, 3), iters=10, warmup=2)
            off = vc.convert(x16, sid=0, seed=0, index_rate=0.0, as_numpy=False)
            on = vc.convert(x16, sid=0, seed=0, as_numpy=False)
            res[name] = dict(rel=rel, ms=ms, mel_off=mel_l1(off, ref_off, sr),
                             mel_on=mel_l1(on, ref_on, sr), rvc_s=[])
        for rep in range(3):
            for name in (list(ways) if rep % 2 == 0 else list(ways)[::-1]):
                P._conv = ways[name]
                sync(dev)
                t0 = time.perf_counter()
                vc.convert(x16, sid=0, seed=0, as_numpy=False)
                sync(dev)
                res[name]["rvc_s"].append(time.perf_counter() - t0)
    finally:
        P._conv = port
    for name, r in res.items():
        log(f"[fidelity] convolutions as {name}: 8 x 512 x 12000 by 256 x 512 x 7 "
            f"{r['ms']:.3f} ms, max|err| / max|y| against fp64 on the rounded operands "
            f"{r['rel']:.3e}; RVC on the 60 s vocals in turns "
            f"{' / '.join(f'{s:.3f}' for s in r['rvc_s'])} s; mel-L1 against fp32, "
            f"retrieval off {r['mel_off']:.6f}, on {r['mel_on']:.6f}")
    # fp32 sums read about 1e-5 of max|y| here, a bf16 result rounding 3e-3
    expect(res[next(iter(ways))]["rel"] < 1e-4,
           "fidelity: the policy's convolution is not the fp32 sum of rounded operands")


def rvc_plan(vc, n16: int):
    """The chunk plan ``convert`` makes of an ``n16``-sample 16 kHz input."""
    from audiolab_tpu_torch.core.chunking import plan_chunks

    chunk = int(vc.cfg.chunk_seconds * RVC_SR)
    overlap = int(vc.cfg.overlap_seconds * RVC_SR)
    return plan_chunks(n16, chunk - chunk % 320, overlap - overlap % 320)


def rvc_groups(vc, n16: int) -> int:
    """Device groups ``convert`` runs on an ``n16``-sample 16 kHz input."""
    count = rvc_plan(vc, n16).count
    return -(-count // max(1, min(vc.cfg.device_batch, count)))


def phase_f0(dev, vc, vocals) -> dict:
    """The f0 methods beside rmvpe, each a ``convert`` of the separator's
    vocals with counts reset just before and read just after: 12 K2 (HuBERT)
    a group and no other kernel."""
    import torch

    from audiolab_tpu_torch.core.chunking import extract_chunks
    from audiolab_tpu_torch.dsp.f0 import f0_harvest
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter

    x16 = to_rvc_input(vocals)
    groups = rvc_groups(vc, x16.shape[-1])
    secs = {}
    for label, method, rmvpe in (("yin, no RMVPE: fused into the conversion", "yin", None),
                                 ("rmvpe+", "rmvpe+", vc.rmvpe),
                                 ("hybrid harvest + rmvpe+", ["harvest", "rmvpe+"], vc.rmvpe)):
        v = VoiceConverter(vc.synth, vc.hubert, rmvpe, index_features=vc.index_features,
                           cfg=RVCPipelineConfig(sr=vc.cfg.sr, f0_method=method,
                                                 matmul_precision=vc.cfg.matmul_precision),
                           device=dev)
        reset_counts()
        t0 = time.perf_counter()
        out = v.convert(x16, sid=0, seed=0, as_numpy=False)
        sync(dev)
        secs[label] = time.perf_counter() - t0
        launches = counts()
        n_out = int(round(x16.shape[-1] * v.synth_cfg.sr / RVC_SR))
        finite = bool(torch.isfinite(out).all())
        log(f"[f0] {label}: {x16.shape[-1] / RVC_SR:.1f} s -> {tuple(out.shape)} finite "
            f"{finite} peak {float(out.abs().max()):.4f} launches {launches} "
            f"{secs[label]:.3f} s")
        expect(tuple(out.shape) == (n_out,) and finite, f"f0 {label}: length or finiteness")
        # CPU tensors take the plain versions and count nothing
        expect(dev.type != "cuda" or only(launches, "K2", HUBERT_LAYERS * groups),
               f"f0 {label}: launches {launches}, expected K2 {HUBERT_LAYERS * groups}")
    plan = rvc_plan(vc, x16.shape[-1])
    rows = extract_chunks(x16, plan).float().cpu().numpy()
    t0 = time.perf_counter()
    for row in rows:
        f0_harvest(row, sr=RVC_SR, hop=160, fmin=vc.cfg.f0_min, fmax=vc.cfg.f0_max)
    secs["harvest on the host alone"] = time.perf_counter() - t0
    log(f"[f0] harvest alone on the host, {len(rows)} chunks of "
        f"{plan.chunk / RVC_SR:.1f} s: {secs['harvest on the host alone']:.3f} s")
    return secs


VR_CASES = (("cascaded_asppnet", "4band_v3"), ("cascaded_net", "1band_sr44100_hl512"))


def phase_vr(dev, vocals, widths: dict | None = None, window: int = 512) -> dict:
    """The VR karaoke split on the stereo vocals stem, one net of each
    generation at VRConfig's default widths (``widths`` overrides them for a
    rehearsal on the CPU), weights by bench.py's rules; counts reset before
    each split and read after (the VR path launches no hand-written
    kernel)."""
    import copy

    import torch

    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.models.separation.vr_bands import (
        BAND_PARAMS,
        combined_spec_to_wave,
        wave_to_combined_spec,
    )
    from audiolab_tpu_torch.pipelines.separate import KARAOKE, vr_split
    from audiolab_tpu_torch.utils.fast_init import fast_init

    secs = {}
    for arch, band in VR_CASES:
        mp = BAND_PARAMS[band]
        cfg = VRConfig(arch=arch, n_fft=2 * mp["bins"], **(widths or {}).get(arch, {}))
        with torch.device(dev):
            net = fast_init(make_vr_net(cfg), seed=200)
        split = vr_split(net, band, KARAOKE, window_size=window, device=dev)
        runs = []
        for _ in range(2):      # the first pass meets these shapes for the first time
            reset_counts()
            t0 = time.perf_counter()
            out = split(vocals, as_numpy=False)
            sync(dev)
            runs.append(time.perf_counter() - t0)
        launches = counts()
        secs[f"{arch} {band}"] = runs
        n = vocals.shape[-1]
        with torch.inference_mode():
            whole = combined_spec_to_wave(wave_to_combined_spec(vocals, mp), mp)
            m = min(n, whole.shape[-1])
            total = out[KARAOKE[0]] + out[KARAOKE[1]]
            err = float((total[:, :m] - whole[:, :m]).abs().max())
            tol = 1e-4 * float(whole.abs().max()) + 1e-6
            win = wave_to_combined_spec(vocals[:, : 128 * mp["band"][len(mp["band"])]["hl"]], mp)
            win = (win.abs() / win.abs().max())[None, :, : cfg.max_bin, :128]
            got = net(win).cpu()
            ref = copy.deepcopy(net).cpu()(win.cpu())
        ferr = float((got - ref).abs().max())
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        log(f"[vr] {arch} on {band} (n_fft {cfg.n_fft}, window {window}), KARAOKE split of "
            f"{n / SEP_SR:.1f} s stereo vocals: {runs[0]:.3f} s, then {runs[1]:.3f} s; "
            f"stems {[tuple(v.shape) for v in out.values()]} finite {finite} launches "
            f"{launches}; primary + complement vs the band round trip max|diff| {err:.3e} "
            f"(tol {tol:.3e}); one forward {tuple(win.shape)}, card vs CPU fp32 max|diff| "
            f"{ferr:.3e} (tol 1e-4)")
        expect(finite and all(tuple(v.shape) == (2, n) for v in out.values()),
               f"vr {arch}: stem shape or finiteness")
        expect(all(v == 0 for v in launches.values()), f"vr {arch}: launches {launches}")
        expect(err <= tol, f"vr {arch}: stems do not sum to the band round trip")
        expect(ferr <= 1e-4, f"vr {arch}: card vs CPU {ferr}")
        del net, split, out, whole, total
        torch.cuda.empty_cache()
    return secs


def phase_long(dev, sep, vc, card: str, seconds: float = LONG_S) -> dict:
    """bench.py's 4-minute track (seed 0, 0.1 * N(0, 1) stereo) through
    separate -> mono -> 44.1 -> 16 kHz -> convert, once after a pass that
    warms these shapes; counts reset just before the measured pass and read
    just after."""
    import torch

    from audiolab_tpu_torch.core.chunking import plan_chunks
    from audiolab_tpu_torch.kernels import attention as A

    audio = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (2, int(seconds * SEP_SR))) * 0.1).astype(np.float32)).to(dev)
    count = plan_chunks(audio.shape[-1], int(sep.chunk_seconds * SEP_SR),
                        int(sep.overlap_seconds * SEP_SR)).count
    sep_groups = -(-count // min(sep.device_batch, count))
    expect_k1 = len(sep.members) * sep_groups * 2 * sep.members[0].apply_fn.cfg.depth

    def chain():
        t0 = time.perf_counter()
        stems = sep.separate(audio, as_numpy=False)
        sync(dev)
        t1 = time.perf_counter()
        x16 = to_rvc_input(stems["vocals"])
        out = vc.convert(x16, sid=0, seed=0, as_numpy=False)
        sync(dev)
        return stems, x16, out, t1 - t0, time.perf_counter() - t1

    *_, w_sep, w_rvc = chain()
    reset_counts()
    stems, x16, out, t_sep, t_rvc = chain()
    launches = counts()
    k1_hopper = A.attention_nk1.sm90_launches
    expect_k2 = HUBERT_LAYERS * rvc_groups(vc, x16.shape[-1])
    finite = (all(bool(torch.isfinite(v).all()) for v in stems.values())
              and bool(torch.isfinite(out).all()))
    total = t_sep + t_rvc
    log(f"[long] {seconds:.0f} s stereo: {count} chunks in {sep_groups} groups a member; "
        f"first pass at these shapes separate {w_sep:.3f} s rvc {w_rvc:.3f} s; measured pass "
        f"separate {t_sep:.3f} s, rvc {t_rvc:.3f} s, chain {total:.3f} s = "
        f"{seconds / total:.3f} audio-s/s; launches {launches} (K1 on the Hopper routes: "
        f"{k1_hopper}); stems and output finite {finite} | {card}")
    n_out = int(round(x16.shape[-1] * vc.synth_cfg.sr / RVC_SR))
    expect(finite and tuple(out.shape) == (n_out,),
           "long: finiteness or output length")
    expect(dev.type != "cuda" or (
        launches["K1"] == expect_k1 == k1_hopper and launches["K2"] == expect_k2
        and all(launches[k] == 0 for k in KERNELS if k not in ("K1", "K2"))),
           f"long: launches {launches}, expected K1 {expect_k1} (all Hopper), K2 {expect_k2}")
    return dict(sep_s=t_sep, rvc_s=t_rvc, chain_s=total, first_sep_s=w_sep, first_rvc_s=w_rvc)


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
    # the stages are timed on the host's clock, which a shared host moves by
    # several percent from pass to pass: two more passes show the spread
    again = [sum(chain()[:2]) for _ in range(2)]
    rec = dict(sep_s=t_sep, rvc_s=t_rvc, chain_s=total, audio_s_per_s=dur / total,
               chain_again_s=again, peak_mem_gb=peak_gb, card=card)
    log(f"[timing] warm chain on {dur:.1f} s: separate {t_sep:.3f} s, rvc {t_rvc:.3f} s, "
        f"chain {total:.3f} s = {dur / total:.3f} audio-s/s (two more passes: "
        f"{' / '.join(f'{x:.3f}' for x in again)} s), peak memory "
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
            check_new_kernels(report.read_text())

    kernel_recs: list[dict] = []
    if "kernels" in phases:
        kernel_recs = phase_kernels(dev, card)

    main_launches = dict.fromkeys(KERNELS, 0)
    need_chain = {"separator", "rvc", "fidelity", "f0", "reference", "timing", "vr",
                  "long"} & set(phases)
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
        if "f0" in phases:
            phase_f0(dev, vcs["bfloat16"], stems["vocals"])
        if "vr" in phases:
            phase_vr(dev, stems["vocals"])
        del stems, x16, out
        if "reference" in phases:
            phase_reference(dev, sep, vcs)
        if "timing" in phases:
            phase_timing(dev, sep, vcs["bfloat16"], audio, card, args.profile)
        if "long" in phases:
            del audio
            torch.cuda.empty_cache()
            phase_long(dev, sep, vcs["bfloat16"], card)

    log(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"launches": main_launches[r["kernel"]], "case": r["case"],
           "on_main_path": r["on_main_path"], "bound_parts_ms": r["bound_parts_ms"]}
        | {k: r[k] for k in ("k1_route", "k2_route", "k3_route", "k6_route", "k7_route",
                             "core_ms") if k in r}
        for r in kernel_recs]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
