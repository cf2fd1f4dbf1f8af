"""The seeded traffic repeats by seed, and seeds change the content, never
the sizes or their order."""

import json

import numpy as np
import torch

from benchmark import generator
from benchmark.reference import dsp

MIX = {"kind": "songs", "sr": 8000, "length_s": [1.0, 3.0], "count": 4,
       "content": json.loads((generator.ROOT / "traffic" / "song.json").read_text())["content"]}


def test_songs_repeat_by_seed():
    a = generator.songs(MIX, 2 ** 33 + 5, "cpu")
    b = generator.songs(MIX, 2 ** 33 + 5, "cpu")
    c = generator.songs(MIX, 12, "cpu")
    assert [x["seed"] for x in a] == [x["seed"] for x in b]
    assert all(np.array_equal(x["audio"], y["audio"]) for x, y in zip(a, b))
    assert not all(x["audio"].shape == y["audio"].shape and np.array_equal(x["audio"], y["audio"])
                   for x, y in zip(a, c))
    # the same lengths in the same order
    assert [x["audio"].shape[-1] for x in a] == [x["audio"].shape[-1] for x in c]
    for x in a:
        assert x["audio"].dtype == np.float32 and x["audio"].shape[0] == 2
        assert np.isfinite(x["audio"]).all() and 0.79 < np.abs(x["audio"]).max() <= 0.8 + 1e-6


def test_stratified_lengths():
    vals = generator.stratified(150.0, 300.0, 14)
    assert sorted(vals) == [150.0 + 150.0 * (i + 0.5) / 14 for i in range(14)]
    assert vals != sorted(vals)


def test_dataset_repeats_by_seed(tmp_path):
    mix = {"sr": 48000, "slice_s": 0.5, "f0_lo": 90.0, "f0_hi": 400.0, "feat_dim": 8}
    paths = [generator.rvc_dataset(mix, 3, s, tmp_path / name)
             for s, name in ((5, "a"), (5, "b"), (6, "c"))]
    lists = [json.loads(open(p).read()) for p in paths]
    for k in ("gt", "feat", "f0", "f0c"):
        for ea, eb, ec in zip(*lists):
            if k == "gt":
                xa, xb, xc = (generator.read_wav_f32(e[k]) for e in (ea, eb, ec))
            else:
                xa, xb, xc = (np.load(e[k]) for e in (ea, eb, ec))
            assert np.array_equal(xa, xb) and not np.array_equal(xa, xc)
    e = lists[0][0]
    f0, f0c = np.load(e["f0"]), np.load(e["f0c"])
    assert np.array_equal(f0c, dsp.coarse_f0(torch.from_numpy(f0)).numpy())
    assert len(generator.read_wav_f32(e["gt"])) == 24000


def test_the_port_reads_the_dataset_as_written(tmp_path):
    from audiolab_tpu_torch.core.audio_io import read_audio

    mix = {"sr": 48000, "slice_s": 0.5, "f0_lo": 90.0, "f0_hi": 400.0, "feat_dim": 8}
    e = json.loads(open(generator.rvc_dataset(mix, 1, 3, tmp_path)).read())[0]
    a = read_audio(e["gt"])
    assert a.sample_rate == 48000
    assert np.array_equal(a.samples[0], generator.read_wav_f32(e["gt"]))
