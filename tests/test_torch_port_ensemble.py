"""The separator family in the port's ensemble and processor against the JAX
package's, on the CPU, in fp32: a tiny BS-RoFormer, MDX23C and 6-source
HTDemucs in one StemSeparator (the shape of the reference's default matrix,
tests/test_ensemble_mixed.py's members), each member alone, the 6-stem
split, and the Separate processor with vocals_only off and the drum split
on (an MDX23C over DRUM_KIT).  Both packages' separators are built once per
module (each JAX member compiles one graph per chunk shape)."""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.models.separation import htdemucs as JHt
from audiolab_tpu.models.separation import mdx23c as JMc
from audiolab_tpu.models.separation import roformer as JRo
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.pipelines.processors import separate as JSepProc
from audiolab_tpu.utils.convert import convert_roformer
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.models.separation import roformer as TRo
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import separate as TSepProc
from audiolab_tpu_torch.utils.weights import roformer_from_jax
from tests import torch_port_tiny as tiny

SR = 8000
SIX = ("drums", "bass", "other", "vocals", "guitar", "piano")
ROFORMER = dict(dim=16, depth=1, heads=2, dim_head=16, n_fft=256, hop=64,
                freqs_per_bands=(64, 65), dtype="float32", stems=("vocals", "other"))
# 0.5 s chunks: one HTDemucs segment, one frame short of MDX23C's multiple
# of 4 frames (padded by the member)
HTD6 = dict(sources=SIX, samplerate=SR, segment_seconds=0.5, nfft=256)
SEP_KW = dict(sr=SR, chunk_seconds=0.5, overlap_seconds=0.1, device_batch=2,
              matmul_precision="highest")
# one PCM-16 step: a stem sample within fp32 rounding of a step's midpoint
# may round either way in the two packages' WAVs
PCM16 = 1.0 / 32767.0 + 1e-6


def _roformer():
    jcfg, tcfg = JRo.RoformerConfig(**ROFORMER), TRo.RoformerConfig(**ROFORMER)
    model = JRo.BSRoformer(jcfg)
    tpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4000))))
    src = tiny.seeded(lambda: TRo.BSRoformer(tcfg), 30)
    p = convert_roformer({k: v.detach().numpy() for k, v in src.state_dict().items()},
                         tpl["params"], stems=jcfg.stems)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), p)
    port = TRo.BSRoformer(tcfg)
    port.load_state_dict(roformer_from_jax(jax.tree_util.tree_map(np.asarray, p), tcfg.stems),
                         strict=True)
    return (JSep.EnsembleMember("rf", lambda pp, b: model.apply({"params": pp}, b), 8.4, 16.0,
                                params=p),
            TSep.EnsembleMember("rf", port.eval(), 8.4, 16.0))


@pytest.fixture(scope="module")
def family():
    """(JAX separator, port separator, {member: (JAX, port)}, audio)."""
    rf = _roformer()
    mp, mm = tiny.mdx23c(seed=31)
    hp, hm = tiny.htdemucs(seed=32, **HTD6)
    dp, dm = tiny.mdx23c(seed=33, instruments=TSep.DRUM_KIT)
    members = {
        "rf": rf,
        "mdx23c": (JSep.mdx23c_member(jax.tree_util.tree_map(jnp.asarray, mp),
                                      JMc.MDX23CConfig(**tiny.MDXC)),
                   TSep.mdx23c_member(mm)),
        "htdemucs": (JSep.htdemucs_member(jax.tree_util.tree_map(jnp.asarray, hp),
                                          JHt.HTDemucsConfig(**dict(tiny.HTD, **HTD6)),
                                          name="htd", weight_vocals=8.6, weight_inst=16.0),
                     TSep.htdemucs_member(hm, name="htd", weight_vocals=8.6, weight_inst=16.0)),
        "drums": (JSep.mdx23c_member(jax.tree_util.tree_map(jnp.asarray, dp), JMc.MDX23CConfig(
            **dict(tiny.MDXC, instruments=TSep.DRUM_KIT)), name="drumsep"),
                  TSep.mdx23c_member(dm, name="drumsep")),
    }
    ens = ("rf", "mdx23c", "htdemucs")
    jsep = JSep.StemSeparator([members[k][0] for k in ens], **SEP_KW)
    tsep = TSep.StemSeparator([members[k][1] for k in ens], device="cpu", **SEP_KW)
    t = np.arange(2 * SR) / SR
    voc = 0.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    inst = 0.2 * np.sin(2 * np.pi * 110 * t) + 0.02 * np.random.default_rng(0).standard_normal(
        t.size)
    audio = np.stack([voc + inst, voc - inst]).astype(np.float32)
    return jsep, tsep, members, audio


def _close(out: dict, ref: dict, scale: float, tol: float = 1e-5):
    assert set(out) == set(ref)
    for stem in ref:
        o, r = np.asarray(out[stem]), np.asarray(ref[stem])
        assert o.shape == r.shape, stem
        np.testing.assert_allclose(o, r, atol=tol * scale, rtol=0, err_msg=stem)


def test_mdx23c_member_matches_jax(family):
    """mdx23c_member's stems over every chunk (each padded from 63 to 64
    frames and trimmed back) to 1e-5 of the input's peak."""
    jsep, tsep, members, audio = family
    jm, tm = members["mdx23c"]
    ref = jsep._run_member(jm, jnp.asarray(audio))
    with torch.no_grad():
        out = tsep._run_member(tm, torch.from_numpy(audio))
    assert set(out) == {"vocals", "instrumental"}
    _close({k: v.numpy() for k, v in out.items()}, ref, np.abs(audio).max())


def test_htdemucs_member_multistem_matches_jax(family):
    """The 6-source htdemucs_member through separate_multistem: six stems to
    1e-5 of the input's peak, the derived "instrumental" dropped, the stems
    summing to the input."""
    jsep, tsep, members, audio = family
    jm, tm = members["htdemucs"]
    ref = jsep.separate_multistem(audio, jm)
    out = tsep.separate_multistem(audio, tm)
    assert set(out) == set(SIX)
    _close(out, ref, np.abs(audio).max())
    np.testing.assert_allclose(sum(out.values()), audio, atol=1e-5 * np.abs(audio).max())


def test_mixed_ensemble_matches_jax(family):
    """RoFormer + MDX23C + HTDemucs blended and de-bled in one separate():
    vocals and instrumental to 1e-5 of the input's peak."""
    jsep, tsep, _, audio = family
    ref = jsep.separate(audio)
    out = tsep.separate(audio)
    assert set(out) == {"vocals", "instrumental"}
    _close(out, ref, np.abs(audio).max())
    assert all(np.isfinite(v).all() for v in out.values())


def test_six_stem_member_gives_other_as_instrumental(family):
    """Both packages take a member's "other" stem, when it has one, as its
    instrumental (stems.get("other", stems.get("instrumental"))): a 6-stem
    HTDemucs alone in separate() blends its "other", not mix - vocals."""
    jsep, tsep, members, audio = family
    jm, tm = members["htdemucs"]
    with torch.no_grad():
        stems = tsep._run_member(tm, torch.from_numpy(audio))
    one = TSep.StemSeparator([tm], device="cpu", **SEP_KW)
    out = one.separate(audio, as_numpy=False)
    quirk = TSep.debleed(stems["other"], stems["vocals"])
    residual = TSep.debleed(stems["instrumental"], stems["vocals"])
    np.testing.assert_allclose(out["instrumental"].numpy(), quirk.numpy(), atol=1e-6)
    assert float((out["instrumental"] - residual).abs().max()) > 1e-2
    ref = JSep.StemSeparator([jm], **SEP_KW).separate(audio)
    _close({k: v.numpy() for k, v in out.items()}, ref, np.abs(audio).max())


@pytest.fixture
def separate_state():
    """Both packages keep injected models on Separate; leave it as found."""
    keys = ("separator", "multistem", "drum_splitter", "woodwind_splitter", "bg_splitter",
            "alt_bass", "transforms")
    saved = [(cls, {k: getattr(cls, k) for k in keys})
             for cls in (JSepProc.Separate, TSepProc.Separate)]
    yield
    for cls, attrs in saved:
        for k, v in attrs.items():
            setattr(cls, k, v)


def test_separate_processor_full_split_matches_jax(family, tmp_path, separate_state):
    """Separate with vocals_only off and the drum split on, configured with
    the ensemble, the 6-stem HTDemucs split and an MDX23C drum kit: the same
    WAV names from both packages (vocals, instrumental, the other five
    sources, six drums_* kit stems) and samples within a PCM-16 step."""
    jsep, tsep, members, audio = family
    song = str(tmp_path / "song.wav")
    write_wav(song, audio, SR)
    (jh, th), (jd, td) = members["htdemucs"], members["drums"]
    # partials, not functions: a function stored on the class binds as a method
    JSepProc.Separate.configure(jsep, multistem=partial(jsep.separate_multistem, member=jh),
                                drum_splitter=partial(jsep.separate_multistem, member=jd))
    TSepProc.Separate.configure(tsep, multistem=partial(tsep.separate_multistem, member=th),
                                drum_splitter=partial(tsep.separate_multistem, member=td))
    settings = {"Separate": {"vocals_only": False, "separate_drums": True, "use_cache": False}}
    j = JC.run_chain(["Separate"], [song], json.loads(json.dumps(settings)),
                     output_root=str(tmp_path / "jax"))
    t = run_chain(["Separate"], [song], json.loads(json.dumps(settings)),
                  output_root=str(tmp_path / "port"), device="cpu")
    names = [os.path.basename(p) for p in t[0].last_outputs]
    assert names == [os.path.basename(p) for p in j[0].last_outputs]
    kit = [f"song (Drums_{s.title()}).wav" for s in TSep.DRUM_KIT]
    assert sorted(names) == sorted(
        [f"song ({s}).wav" for s in ("Vocals", "Instrumental", "Drums", "Bass", "Other",
                                     "Guitar", "Piano")] + kit)
    for jp, tp in zip(j[0].last_outputs, t[0].last_outputs):
        a, b = read_audio(tp), j_read_audio(jp)
        assert a.sample_rate == b.sample_rate == SR and a.samples.shape == b.samples.shape
        assert np.isfinite(a.samples).all()
        assert float(np.abs(a.samples - b.samples).max()) <= PCM16, os.path.basename(tp)
