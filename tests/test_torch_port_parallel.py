"""The port's parallel layer against the JAX package's, on the CPU: the
data-parallel RVC and WaveTransfer steps, the tensor-parallel LM forward and
the separator's dp fan-out, in two gloo ranks (``tests/torch_port_ranks.py``,
started once for the module through ``core.distributed.run_ranks``: a
``file://`` store under the module's temporary directory, one torch thread
a rank, a join timeout, a rank's traceback raised here), and the meshes'
shapes and rule table, in this process.

The multi-rank cases hold each rank against the JAX package on the same
seeded weights, batches and draws, at the tolerances of the single-process
parity tests: the RVC step (a global batch of 2 split 1 + 1, lengths 16
and 12, so the shards' KL mask sums differ) against the JAX unsharded step
(``tests/test_train.py`` holds the JAX dp step equal to it): metrics 1e-4
relative, gradients 1e-4 of each tensor's max|g|
(``tests/test_torch_port_train.py``); two WaveTransfer steps against two
JAX steps (``value_and_grad``, optax Adam, an EMA of decay 0.5): the loss
1e-4, parameters and EMA 1e-2 of an Adam step, the FiLM ``emb`` weights one
step (``tests/test_torch_port_wavetransfer.py``); the tp = 2 LM forward
against the JAX ``shard_lm_params`` forward and the port's replicated one,
2e-4 (``tests/test_parallel.py``); the separator under dp = 2 against the
JAX separator under ``local_mesh(2)``: the same group sizes and stems to
1e-5 (``tests/test_torch_port_separator.py``).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from audiolab_tpu.core import distributed as JDist
from audiolab_tpu.core import mesh as JMeshMod
from audiolab_tpu.models import lm as JLM
from audiolab_tpu.models import wavegrad as JWG
from audiolab_tpu.models.rvc import discriminator as JD
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.models.separation import roformer as JRo
from audiolab_tpu.parallel import shard_lm_params as j_shard_lm_params
from audiolab_tpu.parallel import tp as JTP
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.train import rvc as JR
from audiolab_tpu.utils.convert import llama_mapping
from audiolab_tpu_torch.core import distributed as TDist
from audiolab_tpu_torch.core import mesh as TMesh
from audiolab_tpu_torch.models import lm as TLM
from audiolab_tpu_torch.models import wavegrad as TWG
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.models.separation import roformer as TRo
from audiolab_tpu_torch.parallel import tp as TTP
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.train import wavetransfer as TWT
from audiolab_tpu_torch.train.checkpoint import checkpoint_manager
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_ranks as ranks
from tests import torch_port_tiny as tiny
from tests.test_torch_port_train import METRICS, _draws, _torch_batch
from tests.test_train import make_batch, tiny_cfg
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

PERIODS = (2, 3)
B, T = 2, 16
# unequal, so the shards' KL mask sums differ.  At (16, 13) one leaky ReLU
# input of the period-3 discriminator lies within fp32 rounding of 0 in the
# JAX step, which cannot replay the fp64 step's sides as the port does, and
# moves that discriminator's gradients by 0.6 % of their max|g| (the effect
# tests/test_torch_port_train.py describes); at (16, 12) every gradient of
# the port's single-process step is within 3e-5 of JAX's
LENGTHS = (T, T - 4)
WT_STEPS = 2
LM_KW = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=64,
             max_seq_len=32, dtype="float32")
SEP_TINY = dict(dim=32, depth=2, heads=2, dim_head=16, freqs_per_bands=(16, 16, 32, 65),
                n_fft=256, hop=64, dtype="float32", stems=("vocals",), residual_stem="other")
SEP_KW = dict(sr=8000, chunk_seconds=0.5, overlap_seconds=0.1, device_batch=3,
              matmul_precision="highest")


# ------------------------------------------------------------ references

def _rvc_case():
    """The port ranks' inputs, and the JAX unsharded step on the global
    batch (a thunk): the same weights, batch and draws."""
    cfg = tiny_cfg()
    gp, dp, tg, td = tiny.train_pair(PERIODS)
    batch = make_batch(cfg, b=B, t=T)
    batch["phone_lengths"] = batch["spec_lengths"] = jnp.asarray(LENGTHS, jnp.int32)
    rng = jax.random.PRNGKey(1)
    keys = jax.random.split(jax.random.fold_in(rng, 0), 3)
    inputs = dict(cfg=TSy.SynthesizerConfig(**tiny.SYNTH), periods=PERIODS,
                  gen=tg.state_dict(), disc=td.state_dict(), batch=_torch_batch(batch),
                  draws=_draws(cfg, keys))

    def reference():
        gen, disc = JSy.SynthesizerTrn(cfg), JD.MultiPeriodDiscriminatorV2(PERIODS)
        g_tx, d_tx = JR.make_optimizer(), JR.make_optimizer()
        state = JR.RVCTrainState(step=jnp.zeros((), jnp.int32),
                                 g_params=jax.tree_util.tree_map(jnp.asarray, gp),
                                 d_params=jax.tree_util.tree_map(jnp.asarray, dp),
                                 g_opt=g_tx.init(gp), d_opt=d_tx.init(dp))
        new, jm = JR.make_train_step(cfg, gen, disc)(state, batch, rng)
        grads = [jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.8), opt[0].mu)
                 for opt in (new.g_opt, new.d_opt)]
        return {k: float(v) for k, v in jm.items()}, grads

    return inputs, reference


def _wt_case(work):
    """The port ranks' inputs (a step-0 checkpoint of the same weights, the
    same batches and the JAX keys' draws), and two JAX steps of the
    WaveTransfer trainer's body on the global batch of 2 (a thunk)."""
    jm, _tpl, p, tm = tiny.wavegrad()
    cfg = TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD), sr=8000, n_mels=16,
                       seg_frames=6, batch_size=B, lr=1e-3, steps=WT_STEPS,
                       ckpt_every=WT_STEPS, ema=0.5)
    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((B, 360)).astype(np.float32),
                rng.standard_normal((B, 6, 16)).astype(np.float32)) for _ in range(WT_STEPS)]
    checkpoint_manager(str(work / "wt" / "ckpt")).save(0, {
        "step": 0, "params": tm.state_dict(), "ema": tm.state_dict(),
        "opt": torch.optim.Adam(tm.parameters(), lr=cfg.lr).state_dict()})
    draws = {i: tuple(torch.from_numpy(np.array(v)) for v in
                      tiny.jax_loss_draws(jax.random.PRNGKey(i), B, 360))
             for i in range(WT_STEPS)}
    inputs = dict(cfg=cfg, draws=draws,
                  batches=[tuple(torch.from_numpy(x) for x in bm) for bm in batches])

    def reference():
        tx = optax.adam(cfg.lr)

        @jax.jit
        def step(params, opt, ema, a, m, key):
            loss, g = jax.value_and_grad(lambda q: JWG.diffusion_loss(jm, q, a, m, key))(params)
            upd, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, upd)
            ema = jax.tree_util.tree_map(lambda e, q: cfg.ema * e + (1.0 - cfg.ema) * q, ema,
                                         params)
            return params, opt, ema, loss

        params, ema = p, p
        opt = jax.jit(tx.init)(p)
        for i, (a, m) in enumerate(batches):
            params, opt, ema, loss = step(params, opt, ema, a, m, jax.random.PRNGKey(i))
        return dict(loss=float(loss), params=params, ema=ema, lr=cfg.lr)

    return inputs, reference


def _lm_params(kw, seed):
    lm = JLM.TransformerLM(JLM.LMConfig(**kw))
    toks = jnp.asarray(np.random.default_rng(seed).integers(0, 64, (4, 10)), jnp.int32)
    return lm, jax.jit(lm.init)(jax.random.PRNGKey(seed), toks)["params"], toks


def _tp_case():
    """The port ranks' inputs (the same weights and tokens, and a GQA model,
    4 query heads over 2 key/value heads, held against the port alone), and
    the JAX forward of ``shard_lm_params`` on a 2 x 2 (dp, tp) mesh (a
    thunk)."""
    lm, params, toks = _lm_params(LM_KW, 0)
    gqa = dict(LM_KW, n_kv_heads=2)
    torch_toks = torch.from_numpy(np.array(toks)).long()
    inputs = {
        "mha": (TLM.LMConfig(**LM_KW), W.lm_from_jax(params), torch_toks),
        "gqa": (TLM.LMConfig(**gqa), W.lm_from_jax(_lm_params(gqa, 1)[1]), torch_toks)}

    def reference():
        mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
        ref, _ = jax.jit(lambda q, t: lm.apply({"params": q}, t))(
            j_shard_lm_params(params, mesh), jax.device_put(toks, NamedSharding(mesh, P("dp"))))
        return np.asarray(ref)

    return inputs, reference


def _sep_params(cfg, seed, n=4000):
    tpl = jax.eval_shape(lambda: JRo.BSRoformer(cfg).init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 2, n))))["params"]
    return tiny.filled(tpl, seed)


def _sep_case():
    """The port's inputs (two members of distinct weights), and the JAX
    separator under ``local_mesh(2)`` with its member calls counted (a
    thunk)."""
    jcfg, tcfg = JRo.RoformerConfig(**SEP_TINY), TRo.RoformerConfig(**SEP_TINY)
    x = (0.3 * np.random.default_rng(4).standard_normal((2, 10400))).astype(np.float32)
    weights = [(8.6, 16.0), (8.4, 16.0)]
    params = [_sep_params(jcfg, 10 + i) for i in range(len(weights))]
    members = {f"m{i}": (tcfg, W.roformer_from_jax(p, tcfg.stems), wv, wi)
               for i, (p, (wv, wi)) in enumerate(zip(params, weights))}

    def reference():
        model = JRo.BSRoformer(jcfg)
        apply = jax.jit(lambda pp, b: model.apply({"params": pp}, b))
        calls = []

        def counted(pp, b):
            calls.append(b.shape[0])
            return apply(pp, b)

        j_members = [JSep.EnsembleMember(f"m{i}", counted, wv, wi,
                                         params=jax.tree_util.tree_map(jnp.asarray, p))
                     for i, (p, (wv, wi)) in enumerate(zip(params, weights))]
        sep = JSep.StemSeparator(j_members, mesh=JMeshMod.local_mesh(2), **SEP_KW)
        return sep.separate(x), calls

    return dict(members=members, audio=x, kw=SEP_KW), reference


def _trainer_case(work):
    """An experiment directory prepared by the port (tests/test_torch_port_train_data.py's
    tones and stub HuBERT) for the ranks' trainer run; no JAX reference."""
    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.train import data as TD
    from tests.test_torch_port_train_data import PRE, _stub_hubert_torch, _voice

    raw, exp = work / "raw", work / "exp"
    raw.mkdir()
    for i, (f, seconds) in enumerate([(180, 2.2), (230, 2.0), (150, 2.4)]):
        write_wav(str(raw / f"take{i}.wav"), _voice(48000, seconds, f, i), 48000)
    TD.preprocess_dataset(str(raw), str(exp), TD.PreprocessConfig(**PRE))
    TD.extract_features(str(exp), _stub_hubert_torch, batch_size=4, device="cpu")
    TD.write_filelist(str(exp), sid=0)
    synth = dict(tiny.SYNTH, spec_channels=1025)
    return dict(exp=str(exp), synth=synth), lambda: None


@pytest.fixture(scope="module")
def parallel(tmp_path_factory):
    """Every case's inputs, then the two ranks once (in a thread of this
    process, each rank running every case) while this process computes the
    JAX references."""
    work = tmp_path_factory.mktemp("ranks")
    cases = dict(rvc=_rvc_case(), wavetransfer=_wt_case(work), tp=_tp_case(),
                 separate=_sep_case(), trainer=_trainer_case(work))
    torch.save({k: inputs for k, (inputs, _) in cases.items()}, work / "inputs.pt")
    ranks_out: dict = {}

    def launch():
        try:
            ranks_out["out"] = TDist.run_ranks(
                ranks.body, 2, (f"file://{work}/store", str(work / "inputs.pt"), str(work)),
                timeout=240, threads=1)
        except BaseException as e:  # noqa: BLE001 - raised in the fixture below
            ranks_out["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    refs = {k: reference() for k, (_, reference) in cases.items()}
    thread.join()
    if "error" in ranks_out:
        raise ranks_out["error"]
    sep_ref, sep_calls = refs["separate"]
    return dict(out=ranks_out["out"], rvc=refs["rvc"], wt=refs["wavetransfer"],
                tp=refs["tp"], sep=(cases["separate"][0], sep_ref, sep_calls), work=work)


# ------------------------------------------------------------ multi-rank

def test_ranks_joined_one_process_group(parallel):
    for rank, r in enumerate(parallel["out"]):
        assert r["info"] == {"process_index": rank, "process_count": 2, "local_devices": 1,
                             "global_devices": 2}
        assert r["dp"] == 2


@pytest.mark.parametrize("metric", METRICS)
def test_dp_rvc_step_metrics_match_jax(parallel, metric):
    """Every rank reports the global batch's metrics (the KL term's ratio of
    the reduced sums, not a mean of the shards' ratios)."""
    want = parallel["rvc"][0][metric]
    for r in parallel["out"]:
        assert r["rvc"]["metrics"][metric] == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_dp_rvc_step_gradients_match_jax(parallel, net):
    """The averaged gradients every rank updates with: the same on both
    ranks, and each tensor within 1e-4 of its max|g| of the JAX step's (the
    key projection's bias, exactly 0 in theory, against its layer's key
    weight's max|g|, as in tests/test_torch_port_train.py)."""
    grads = parallel["rvc"][1][0 if net == "gen" else 1]
    ref = (W.synthesizer_from_jax if net == "gen" else W.discriminator_from_jax)(grads)
    r0, r1 = (r["rvc"][net] for r in parallel["out"])
    assert set(r0) == set(ref)
    for k, g in ref.items():
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        g = g.numpy()
        scale = ref[k.replace(".bias", ".weight")] if k.endswith("conv_k.bias") else g
        tol = 1e-4 * np.abs(np.asarray(scale)).max()
        np.testing.assert_allclose(r0[k], g, atol=tol, rtol=0, err_msg=k)


def test_dp_wavetransfer_steps_match_jax(parallel):
    """Two data-parallel steps: the global loss on every rank within 1e-4,
    rank 0's checkpoint (the only one written after the start) with the
    parameters and EMA within 1e-2 of an Adam step of the JAX ones (the
    FiLM ``emb`` weights one step)."""
    ref, work = parallel["wt"], parallel["work"]
    for r in parallel["out"]:
        assert r["wavetransfer"]["loss"] == pytest.approx(ref["loss"], rel=1e-4)
        assert r["wavetransfer"]["written"] == ["ckpt_0.pt", f"ckpt_{WT_STEPS}.pt"]
    state = torch.load(work / "wt" / "ckpt" / f"ckpt_{WT_STEPS}.pt", weights_only=True)
    for key in ("params", "ema"):
        want = W.wavegrad_from_jax(jax.tree_util.tree_map(np.asarray, ref[key]))
        assert set(state[key]) == set(want)
        for name, v in state[key].items():
            tol = ref["lr"] if name.endswith(".emb.weight") else 1e-2 * ref["lr"]
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=tol, rtol=0,
                                       err_msg=f"{key} {name}")


def test_dp_wavetransfer_refuses_a_batch_the_ranks_cannot_split(parallel):
    """A batch of 3 over two ranks raises on both, before either builds a
    model or writes a checkpoint (each rank would otherwise train the
    whole batch and write the same files)."""
    for r in parallel["out"]:
        assert r["wt_refused"] == {"error": "2 ranks need a batch size that divides by them, "
                                            "not 3", "written": False}


@pytest.mark.parametrize("case", ["mha", "gqa"])
def test_tp_lm_forward_matches(parallel, case):
    """tp = 2: each rank computes half the heads (its own counts) and the
    row-parallel sums; the logits within 2e-4 of the port's replicated
    forward and (the MHA model) of the JAX ``shard_lm_params`` forward."""
    kw = LM_KW if case == "mha" else dict(LM_KW, n_kv_heads=2)
    for r in parallel["out"]:
        got = r["tp"][case]
        assert got["heads"] == (kw["n_heads"] // 2, kw["n_kv_heads"] // 2)
        assert got["q_rows"] == kw["dim"] // 2
        np.testing.assert_allclose(got["tp"], got["replicated"], rtol=2e-4, atol=2e-4)
        if case == "mha":
            np.testing.assert_allclose(got["tp"], parallel["tp"], rtol=2e-4, atol=2e-4)


def test_separator_over_ranks_matches_jax(parallel):
    """dp = 2 over the ranks: each rank's member calls take half of each
    group the JAX separator forms under ``local_mesh(2)`` (3 chunks at
    device_batch 3, raised to a group of 4), and every rank's stems are the
    JAX stems to 1e-5."""
    _inp, ref, calls = parallel["sep"]
    assert calls == [4, 4]
    for r in parallel["out"]:
        assert r["separate"]["calls"] == [2, 2]
        for stem in ("vocals", "instrumental"):
            np.testing.assert_allclose(r["separate"]["stems"][stem], ref[stem], atol=1e-5,
                                       rtol=0)


def test_trainer_command_line_over_two_ranks(parallel):
    """``python -m audiolab_tpu_torch.train.trainer`` in the started group:
    both ranks take the data-parallel step and end with the same metrics;
    rank 0 alone prints them, and the state file, the checkpoint and the
    exported voice are written once."""
    r0, r1 = (r["trainer"] for r in parallel["out"])
    exp = parallel["work"] / "exp"
    state = json.loads((exp / "train_state.json").read_text())
    assert r0["state"] == r1["state"] == state
    assert json.loads(r0["printed"]) == state["metrics"] and r1["printed"] == ""
    assert all(np.isfinite(v) for v in state["metrics"].values())
    n = len(json.loads((exp / "filelist.json").read_text()))
    assert state["step"] == n // 2 >= 2
    assert (exp / "model_final.npz").exists() and (exp / "model_best.npz").exists()
    assert [p.name for p in (exp / "ckpt").iterdir()] == [f"ckpt_{state['step']}.pt"]


# ------------------------------------------------------------ one process

def test_separator_refuses_a_one_process_mesh_of_several_slots():
    """The separator fans out over ranks only: a one-process mesh of two
    slots (which no rank runs) raises before any chunk is cut, while one
    slot names the separator's device."""
    with pytest.raises(ValueError, match="ranks of a process group"):
        TSep.StemSeparator([], mesh=TMesh.local_mesh(2, device="cpu"), **SEP_KW)
    sep = TSep.StemSeparator([], mesh=TMesh.local_mesh(1, device="cpu"), **SEP_KW)
    assert sep.device.type == "cpu" and sep.device_batch == SEP_KW["device_batch"]


def test_tp_rule_table_matches_jax():
    """Each LM parameter's placement over tp against JAX's ``_spec_for`` on
    the flax path ``llama_mapping`` names for it: P(None, "tp") on a (in,
    out) kernel is Shard(0) of torch's (out, in) weight, P("tp", None)
    Shard(1), P() replicated."""
    from torch.distributed.tensor import Replicate, Shard

    lm, params, _ = _lm_params(LM_KW, 0)
    names = {key + (".weight" if kind == "dense_w" else ""): path
             for path, (kind, key) in llama_mapping(params).items()}
    model = TLM.TransformerLM(TLM.LMConfig(**LM_KW))
    rules = TTP.lm_tp_shardings(model, TMesh.local_mesh(1, device="cpu"))
    assert set(rules) == set(names)
    as_torch = {(None, "tp"): Shard(0), ("tp", None): Shard(1), (): Replicate()}
    for name, path in names.items():
        spec = JTP._spec_for(tuple(path.split("/")), None)
        assert rules[name] == as_torch[tuple(spec)], name
    assert sum(isinstance(r, Shard) for r in rules.values()) == 2 * 7


def test_tp_refuses_head_counts_it_cannot_split():
    cfg = TLM.LMConfig(**dict(LM_KW, n_heads=6, n_kv_heads=3, dim=48))
    mesh = TMesh.Mesh(1, 4, device_mesh=object())
    with pytest.raises(ValueError, match="n_heads 6, n_kv_heads 3"):
        TTP.shard_lm_params(TLM.TransformerLM(cfg), mesh)
    with pytest.raises(ValueError, match="process group"):
        TTP.shard_lm_params(TLM.TransformerLM(TLM.LMConfig(**LM_KW)), TMesh.local_mesh(
            2, tp=2, devices=["cpu", "cpu"]))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_factor_and_local_mesh_shapes_match_jax(n, tp):
    assert TMesh._factor(n, tp) == JMeshMod._factor(n, tp)
    got, want = TMesh.local_mesh(n, tp, device="cpu"), JMeshMod.local_mesh(n, tp)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert len(got.devices) == n and got.devices[0].type == "cpu"


def test_init_distributed_single_process_summary():
    """No arguments, no torchrun environment: a no-op with the JAX
    package's four keys."""
    got = TDist.init_distributed(device="cpu")
    want = JDist.init_distributed()
    assert set(got) == set(want)
    assert got == {"process_index": 0, "process_count": 1, "local_devices": 1,
                   "global_devices": 1}
    assert not torch.distributed.is_initialized()
