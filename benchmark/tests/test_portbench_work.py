"""The work counts against hand counts at tiny shapes."""

import json

import pytest
import torch
from torch import nn

from benchmark.work import attention as aw
from benchmark.work import flops


def test_attention_call_work_by_hand():
    c = aw.Call("K1", bh=6, tq=5, tk=7, d=4, elem_bytes=2)
    assert c.flops == 4 * 6 * 5 * 7 * 4                      # q.k and p.v, 2 flops a product
    assert c.bytes == 2 * 6 * 4 * (5 + 7 + 7 + 5)            # q, k, v read once, out written once
    assert c.roofline_s(1e3, 1e9) == pytest.approx(c.flops / 1e3)
    assert c.roofline_s(1e12, 1.0) == pytest.approx(c.bytes)


def test_roformer_and_hubert_calls():
    sep = {"chunk_s": 1.0, "sr": 1024, "hop": 256, "freqs_per_bands": [2, 3, 4], "heads": 2,
           "dim_head": 8, "dtype": "bfloat16", "depth": 3}
    calls = aw.roformer_calls(sep, 5)
    t = 1 + 1024 // 256
    assert calls == [aw.Call("K1", 5 * 3 * 2, t, t, 8, 2), aw.Call("K1", 5 * t * 2, 3, 3, 8, 2)] * 3
    assert aw.hubert_frames(128000) == 399                   # 8 s at 16 kHz: 50 frames/s
    conv = {"chunk_s": 8.0, "hubert": {"dim": 768, "heads": 12, "layers": 12}}
    assert aw.hubert_calls(conv, 8) == [aw.Call("K2", 96, 399, 399, 64, 4)] * 12


def test_flop_counter_by_hand():
    lin, cv = nn.Linear(6, 4), nn.Conv1d(3, 5, 7)
    x, y = torch.zeros(2, 9, 6, device="meta"), torch.zeros(2, 3, 20, device="meta")
    with torch.device("meta"):
        lin, cv = nn.Linear(6, 4), nn.Conv1d(3, 5, 7)
    assert flops.count(lambda: lin(x)) == 2 * 2 * 9 * 6 * 4
    assert flops.count(lambda: cv(y)) == 2 * 2 * 5 * 14 * 3 * 7
    q = torch.zeros(1, 2, 5, 8, device="meta")
    from benchmark.reference.roformer import attention

    assert flops.count(lambda: attention(q, q, q)) == aw.Call("K1", 2, 5, 5, 8, 4).flops
    assert flops.gru_flops(10, 3, 4) == 2 * 10 * 2 * 3 * 4 * (3 + 4)


def test_chain_work_of_a_song_by_hand(tree):
    """A song's attention calls: two axes at every depth step of every
    separator batch of both members, and every HuBERT layer of every
    converter group."""
    from benchmark import harness

    chain = harness.plugin("systems", "chain")
    cfg = json.loads((tree / "benchmark" / "configs" / "tiny-chain.json").read_text())
    cfg["name"] = "chain-bsroformer2-rvc48k"        # the same reference code
    sep, conv = cfg["separator"], cfg["converter"]
    n = int(2.2 * sep["sr"])
    groups = chain.separator_groups(n, sep)
    assert sum(groups) >= -(-(n - int(sep["overlap_s"] * sep["sr"]))
                            // int((sep["chunk_s"] - sep["overlap_s"]) * sep["sr"]))
    work = chain.chain_work(cfg, [n])
    k1 = [c for c in work["attention"] if c.kernel == "K1"]
    k2 = [c for c in work["attention"] if c.kernel == "K2"]
    assert len(k1) == 2 * len(groups) * 2 * sep["depth"]
    n16 = -(-n * 16000 // sep["sr"])
    assert len(k2) == len(chain.converter_groups(n16, conv)) * conv["hubert"]["layers"]
    assert work["model_flops"] > 0
