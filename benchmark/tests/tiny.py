"""A checkout of the benchmark with tiny configurations and short traffic,
made under a temporary directory, for the CPU tests: the harness finds the
extra cells, mixes and metrics there by name, as it finds the real ones."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_CHAIN = {
    "separator": {"dim": 32, "depth": 1, "heads": 2, "dim_head": 16, "n_fft": 256, "hop": 64,
                  "freqs_per_bands": [16] * 8 + [1], "chunk_s": 0.5, "overlap_s": 0.05,
                  "device_batch": 3, "reference_batch": 2},
    "converter": {"chunk_s": 1.0, "overlap_s": 0.1, "device_batch": 2,
                  "hubert": {"dim": 32, "ffn_dim": 64, "heads": 2, "layers": 1},
                  "synthesizer": {"inter_channels": 16, "hidden_channels": 16,
                                  "filter_channels": 32, "n_heads": 2, "n_layers": 1,
                                  "upsample_initial_channel": 32, "spk_embed_dim": 4,
                                  "gin_channels": 16, "feat_channels": 32}},
    "index": {"rows": 600, "piece_frames": 50, "batch": 4},
    # the tiny sizes' own limits: their sound runs on the CPU read up to
    # 0.012 / 0.0013 / 0.0017 / 0.022, the fp8 control from 0.098 / 0.0059 /
    # 0.017 / 0.134 (seeds 7-9)
    "limits": {"vocals_rel_l2": 0.05, "instrumental_rel_l2": 0.004, "salience_rel_l2": 0.006,
               "converted_mel_l1": 0.08},
}
TINY_SONGS = {"length_s": [1.5, 2.5], "count": 3}
TINY_TRAIN = {
    "slices": 8, "batch": 2, "periods": [2, 3],
    "synthesizer": {"segment_size": 3840, "inter_channels": 16, "hidden_channels": 16,
                    "filter_channels": 32, "n_heads": 2, "n_layers": 1,
                    "upsample_initial_channel": 32, "spk_embed_dim": 4, "gin_channels": 16,
                    "feat_channels": 32},
}
TINY_STEPS = {"slice_s": 0.8, "feat_dim": 32}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def make_tree(tmp: Path) -> Path:
    """A checkout under ``tmp``: the benchmark's files, BENCHMARK.json with
    the cells ``tiny.chain`` and ``tiny.train`` added, the port linked."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "audiolab_tpu_torch", root / "audiolab_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    chain = json.loads((BENCH / "configs" / "chain-bsroformer2-rvc48k.json").read_text())
    tiny = merge(chain, TINY_CHAIN)
    tiny["name"] = "tiny-chain"
    (root / "benchmark" / "configs" / "tiny-chain.json").write_text(json.dumps(tiny))
    ref = root / "benchmark" / "reference"
    shutil.copytree(ref / "chain-bsroformer2-rvc48k", ref / "tiny-chain")
    song = json.loads((BENCH / "traffic" / "song.json").read_text())
    (root / "benchmark" / "traffic" / "tiny-song.json").write_text(
        json.dumps(merge(song, TINY_SONGS)))
    train = merge(json.loads((BENCH / "configs" / "train-rvc48k.json").read_text()), TINY_TRAIN)
    train["name"] = "tiny-train"
    (root / "benchmark" / "configs" / "tiny-train.json").write_text(json.dumps(train))
    shutil.copytree(ref / "train-rvc48k", ref / "tiny-train")
    steps = json.loads((BENCH / "traffic" / "steps.json").read_text())
    (root / "benchmark" / "traffic" / "tiny-steps.json").write_text(
        json.dumps(merge(steps, TINY_STEPS)))
    spec["configs"].append({"name": "tiny-train", "source": "test",
                            "file": "benchmark/configs/tiny-train.json", "reduced": []})
    spec["workloads"].append({"name": "tiny.train", "config": "tiny-train",
                              "traffic": "tiny-steps", "chips": 1, "why": "test"})
    spec["configs"].append({"name": "tiny-chain", "source": "test",
                            "file": "benchmark/configs/tiny-chain.json", "reduced": []})
    spec["workloads"].append({"name": "tiny.chain", "config": "tiny-chain",
                              "traffic": "tiny-song", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        for real, tiny in (("chain.song", "tiny.chain"), ("train.step", "tiny.train")):
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_cpu(root: Path, workload: str, seed: int = 7, seconds: float = 0.01, trace: int = 0,
            patch: str | None = None, timeout: float = 900.0,
            device: str = "cpu") -> subprocess.CompletedProcess:
    """The harness in a subprocess of ``root`` on ``device`` (the look for
    a card skipped); ``patch``: a name in the cell's system's ``PATCHES``."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + ([] if patch is None else ["--patch", patch])
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(root)!r}]\n"
        "from benchmark import harness\n"
        f"sys.exit(harness.main({argv!r}, require_card=False, device={device!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=timeout, env=env)


def result(proc: subprocess.CompletedProcess) -> dict:
    if proc.returncode != 0:
        raise AssertionError(f"exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
