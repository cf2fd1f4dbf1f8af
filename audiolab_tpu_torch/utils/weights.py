"""Parameter trees of the JAX package -> ``state_dict``s of the port.

Each function takes a flax parameter tree (nested dicts of numpy or JAX
arrays) and returns the port module's ``state_dict`` under the upstream
checkpoint names.  It inverts the transforms of
audiolab_tpu/utils/convert.py: Dense kernels are transposed; conv kernels
go from (k, in, out) to (out, in, k); transposed-conv kernels get the
spatial flip back; the RoFormer's scanned depth axis and per-band
parameters are split out; GRU gates are packed in torch's (r, z, n) order,
with the hidden-side bias only on n.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _dense(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _dense_as_conv1x1(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T[:, :, None])
    sd[f"{key}.bias"] = _t(node["bias"])


def _conv1d(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _conv2d(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _conv_t1d(sd: dict, key: str, node: dict) -> None:
    """flax ConvTranspose (k, in, out), spatially flipped -> torch (in, out, k)."""
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(node["kernel"])[::-1], (1, 2, 0)))
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _conv_t2d(sd: dict, key: str, node: dict) -> None:
    """flax ConvTranspose (kh, kw, in, out), spatially flipped -> torch
    (in, out, kh, kw)."""
    kern = np.asarray(node["kernel"])[::-1, ::-1]
    sd[f"{key}.weight"] = _t(np.transpose(kern, (2, 3, 0, 1)))
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _norm(sd: dict, key: str, node: dict, names=("weight", "bias")) -> None:
    sd[f"{key}.{names[0]}"] = _t(node["scale"])
    sd[f"{key}.{names[1]}"] = _t(node["bias"])


def _count(node: dict, prefix: str) -> int:
    return sum(1 for k in node if k.startswith(prefix))


# ------------------------------------------------------------ BS-RoFormer

def _transformer(sd: dict, prefix: str, tpl: dict) -> None:
    for j in range(_count(tpl, "attn_")):
        a, f = tpl[f"attn_{j}"], tpl[f"ff_{j}"]
        pa, pf = f"{prefix}.layers.{j}.0", f"{prefix}.layers.{j}.1.net"
        sd[f"{pa}.norm.gamma"] = _t(a["norm"]["scale"])
        _dense(sd, f"{pa}.to_qkv", a["to_qkv"])
        _dense(sd, f"{pa}.to_gates", a["to_gates"])
        _dense(sd, f"{pa}.to_out.0", a["to_out"])
        sd[f"{pf}.0.gamma"] = _t(f["norm"]["scale"])
        _dense(sd, f"{pf}.1", f["fc1"])
        _dense(sd, f"{pf}.4", f["fc2"])
    sd[f"{prefix}.norm.gamma"] = _t(tpl["norm"]["scale"])


def roformer_from_jax(params: dict, stems=None) -> dict:
    """BSRoformer flax params (depth scanned into ``depth/{time,freq}``) ->
    port state_dict.  ``stems``: the config's stems, in order (default: the
    tree's ``mask_*`` entries in order)."""
    sd: dict = {}
    bs = params["band_split"]
    for i in range(_count(bs, "norm_scale_")):
        sd[f"band_split.to_features.{i}.0.gamma"] = _t(bs[f"norm_scale_{i}"])
        sd[f"band_split.to_features.{i}.1.weight"] = _t(np.asarray(bs[f"proj_kernel_{i}"]).T)
        sd[f"band_split.to_features.{i}.1.bias"] = _t(bs[f"proj_bias_{i}"])
    stacked = params["depth"]
    depth = np.asarray(stacked["time"]["norm"]["scale"]).shape[0]

    def layer(tree, d):
        return {k: layer(v, d) if isinstance(v, dict) else np.asarray(v)[d]
                for k, v in tree.items()}

    for d in range(depth):
        for ai, axis in enumerate(("time", "freq")):
            _transformer(sd, f"layers.{d}.{ai}", layer(stacked[axis], d))
    sd["final_norm.gamma"] = _t(params["final_norm"]["scale"])
    if stems is None:
        stems = [k[len("mask_"):] for k in params if k.startswith("mask_")]
    for s, stem in enumerate(stems):
        m = params[f"mask_{stem}"]
        n_bands = _count(m, "out_kernel_")
        n_hidden = sum(1 for k in m if k.startswith("mlp_kernel_0_"))
        for b in range(n_bands):
            base = f"mask_estimators.{s}.to_freqs.{b}.0"
            for k in range(n_hidden):
                _dense(sd, f"{base}.{2 * k}",
                       {"kernel": m[f"mlp_kernel_{b}_{k}"], "bias": m[f"mlp_bias_{b}_{k}"]})
            _dense(sd, f"{base}.{2 * n_hidden}",
                   {"kernel": m[f"out_kernel_{b}"], "bias": m[f"out_bias_{b}"]})
    return sd


# ------------------------------------------------------------------ HuBERT

def hubert_from_jax(params: dict) -> dict:
    """HubertFeatureExtractor (or bare Hubert) flax params -> port
    state_dict (fairseq names)."""
    sd: dict = {}
    hub = params.get("hubert", params)
    fe = hub["feature_extractor"]
    for i in range(_count(fe, "conv_")):
        _conv1d(sd, f"feature_extractor.conv_layers.{i}.0", fe[f"conv_{i}"])
    _norm(sd, "feature_extractor.conv_layers.0.2", fe["gn_0"])
    _norm(sd, "layer_norm", hub["ln_post_extract"])
    _dense(sd, "post_extract_proj", hub["post_extract_proj"])
    _conv1d(sd, "encoder.pos_conv.0", hub["pos_conv"])
    _norm(sd, "encoder.layer_norm", hub["ln_pre"])
    for i in range(_count(hub, "layer_")):
        ly, b = hub[f"layer_{i}"], f"encoder.layers.{i}"
        for w in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{b}.self_attn.{w}", ly["attn"][w])
        _norm(sd, f"{b}.self_attn_layer_norm", ly["ln1"])
        _dense(sd, f"{b}.fc1", ly["fc1"])
        _dense(sd, f"{b}.fc2", ly["fc2"])
        _norm(sd, f"{b}.final_layer_norm", ly["ln2"])
    if "final_proj" in params and params is not hub:
        _dense(sd, "final_proj", params["final_proj"])
    return sd


# ------------------------------------------------------------------- RMVPE

def _bn(sd: dict, key: str, p: dict, s: dict) -> None:
    _norm(sd, key, p)
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _rmvpe_block(sd: dict, key: str, p: dict, s: dict) -> None:
    _conv2d(sd, f"{key}.conv.0", p["conv1"])
    _bn(sd, f"{key}.conv.1", p["bn1"], s["bn1"])
    _conv2d(sd, f"{key}.conv.3", p["conv2"])
    _bn(sd, f"{key}.conv.4", p["bn2"], s["bn2"])
    if "shortcut" in p:
        _conv2d(sd, f"{key}.shortcut", p["shortcut"])


def _gru(sd: dict, base: str, sfx: str, cell: dict) -> None:
    def w(name):
        return np.asarray(cell[name]["kernel"]).T

    hidden = np.asarray(cell["hn"]["bias"]).shape[0]
    sd[f"{base}.weight_ih_{sfx}"] = _t(np.concatenate([w("ir"), w("iz"), w("in")]))
    sd[f"{base}.weight_hh_{sfx}"] = _t(np.concatenate([w("hr"), w("hz"), w("hn")]))
    sd[f"{base}.bias_ih_{sfx}"] = _t(np.concatenate(
        [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")]))
    sd[f"{base}.bias_hh_{sfx}"] = _t(np.concatenate(
        [np.zeros(2 * hidden, np.float32), np.asarray(cell["hn"]["bias"])]))


def rmvpe_from_jax(params: dict, batch_stats: dict) -> dict:
    """E2E flax params + batch_stats -> port state_dict (rmvpe.pt names)."""
    sd: dict = {}
    unet, st = params["unet"], batch_stats["unet"]
    _bn(sd, "unet.encoder.bn", unet["bn_in"], st["bn_in"])
    for name, tpl in unet.items():
        if name.startswith(("enc_", "inter_")):
            i = int(name.split("_")[1])
            stage = "encoder" if name.startswith("enc_") else "intermediate"
            for bname, btpl in tpl.items():
                j = int(bname.split("_")[1])
                _rmvpe_block(sd, f"unet.{stage}.layers.{i}.conv.{j}", btpl, st[name][bname])
        elif name.startswith("dec_"):
            i = int(name.split("_")[1])
            key = f"unet.decoder.layers.{i}"
            _conv_t2d(sd, f"{key}.conv1.0", tpl["convt"])
            _bn(sd, f"{key}.conv1.1", tpl["bn"], st[name]["bn"])
            for bname, btpl in tpl.items():
                if bname.startswith("block_"):
                    j = int(bname.split("_")[1])
                    _rmvpe_block(sd, f"{key}.conv2.{j}", btpl, st[name][bname])
    _conv2d(sd, "cnn", params["cnn"])
    _gru(sd, "fc.0.gru", "l0", params["gru"]["GRUCell_0"])
    _gru(sd, "fc.0.gru", "l0_reverse", params["gru"]["GRUCell_1"])
    _dense(sd, "fc.1", params["fc"])
    return sd


# ------------------------------------------------------------- synthesizer

def _wn_rows(path: str, key: str, layers: int, cond: bool) -> list[tuple[str, str, str]]:
    out = []
    for j in range(layers):
        out.append((f"{path}/in_layer_{j}/Conv_0", "conv", f"{key}.in_layers.{j}"))
        out.append((f"{path}/res_skip_{j}/Conv_0", "conv", f"{key}.res_skip_layers.{j}"))
    if cond:
        out.append((f"{path}/cond_layer/Conv_0", "conv", f"{key}.cond_layer"))
    return out


def _flow_rows(n: dict) -> list[tuple[str, str, str]]:
    rows = []
    for fi in range(n["flows"]):
        f, t = f"flow/flow_{fi}", f"flow.flows.{2 * fi}"
        rows += [(f"{f}/pre/Conv_0", "conv", f"{t}.pre"), (f"{f}/post/Conv_0", "conv", f"{t}.post")]
        rows += _wn_rows(f"{f}/enc", f"{t}.enc", n["flow_layers"], n["flow_cond"])
    return rows


def _enc_q_rows(n: dict) -> list[tuple[str, str, str]]:
    return ([("enc_q/pre/Conv_0", "conv", "enc_q.pre"), ("enc_q/proj/Conv_0", "conv", "enc_q.proj")]
            + _wn_rows("enc_q/enc", "enc_q.enc", n["enc_q"], n["enc_q_cond"]))


def _synth_table(n: dict) -> list[tuple[str, str, str]]:
    """(flax path, kind, torch key) of every SynthesizerTrn entry, for the
    counts ``n`` (:func:`_synth_counts_jax` / :func:`_synth_counts_torch`)."""
    rows = [("enc_p/emb_phone", "dense", "enc_p.emb_phone")]
    if n["pitch"]:
        rows.append(("enc_p/emb_pitch/embedding", "leaf", "enc_p.emb_pitch.weight"))
    rows.append(("enc_p/proj/Conv_0", "conv", "enc_p.proj"))
    b = "enc_p.encoder"
    for i in range(n["attn"]):
        a = f"enc_p/encoder/attn_{i}"
        rows += [(f"{a}/{w}", "dense1x1", f"{b}.attn_layers.{i}.{w}")
                 for w in ("conv_q", "conv_k", "conv_v", "conv_o")]
        rows += [(f"{a}/emb_rel_{w}", "leaf", f"{b}.attn_layers.{i}.emb_rel_{w}") for w in "kv"]
        rows += [(f"enc_p/encoder/norm{j}_{i}", "norm", f"{b}.norm_layers_{j}.{i}") for j in (1, 2)]
        rows += [(f"enc_p/encoder/ffn_{i}/conv_{j}/Conv_0", "conv", f"{b}.ffn_layers.{i}.conv_{j}")
                 for j in (1, 2)]

    rows += _flow_rows(n)
    if n["enc_q"]:
        rows += _enc_q_rows(n)
    rows += [("dec/conv_pre/Conv_0", "conv", "dec.conv_pre"),
             ("dec/conv_post/Conv_0", "conv", "dec.conv_post"),
             ("dec/source_linear", "dense", "dec.m_source.l_linear")]
    if n["dec_cond"]:
        rows.append(("dec/cond/Conv_0", "conv", "dec.cond"))
    for i in range(n["ups"]):
        rows.append((f"dec/up_{i}/ConvTranspose_0", "conv_t", f"dec.ups.{i}"))
        rows.append((f"dec/noise_conv_{i}", "conv", f"dec.noise_convs.{i}"))
        for j in range(n["kernels"]):
            flat = i * n["kernels"] + j
            for k in range(n["dilations"]):
                for ours, theirs in (("conv1", "convs1"), ("conv2", "convs2")):
                    rows.append((f"dec/resblock_{i}_{j}/{ours}_{k}/Conv_0", "conv",
                                 f"dec.resblocks.{flat}.{theirs}.{k}"))
    rows.append(("emb_g/embedding", "leaf", "emb_g.weight"))
    return rows


def _synth_counts_jax(params: dict) -> dict:
    enc_q = params.get("enc_q", {}).get("enc", {})
    dec = params["dec"]
    return dict(
        pitch="emb_pitch" in params["enc_p"],
        attn=_count(params["enc_p"]["encoder"], "attn_"),
        flows=_count(params["flow"], "flow_"),
        flow_layers=_count(params["flow"]["flow_0"]["enc"], "in_layer_"),
        flow_cond="cond_layer" in params["flow"]["flow_0"]["enc"],
        enc_q=_count(enc_q, "in_layer_"), enc_q_cond="cond_layer" in enc_q,
        dec_cond="cond" in dec, ups=_count(dec, "up_"), kernels=_count(dec, "resblock_0_"),
        dilations=_count(dec["resblock_0_0"], "conv1_"))


def _synth_counts_torch(sd: dict) -> dict:
    def count(pattern):
        rx = re.compile(pattern)
        return len({m.group(1) for k in sd for m in [rx.match(k)] if m})

    ups = count(r"dec\.ups\.(\d+)\.")
    return dict(
        pitch="enc_p.emb_pitch.weight" in sd,
        attn=count(r"enc_p\.encoder\.attn_layers\.(\d+)\."),
        flows=count(r"flow\.flows\.(\d+)\.pre\."),
        flow_layers=count(r"flow\.flows\.0\.enc\.in_layers\.(\d+)\."),
        flow_cond="flow.flows.0.enc.cond_layer.weight" in sd,
        enc_q=count(r"enc_q\.enc\.in_layers\.(\d+)\."),
        enc_q_cond="enc_q.enc.cond_layer.weight" in sd,
        dec_cond="dec.cond.weight" in sd, ups=ups,
        kernels=count(r"dec\.resblocks\.(\d+)\.") // max(ups, 1),
        dilations=count(r"dec\.resblocks\.0\.convs1\.(\d+)\."))


def _node(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _fill_rows(sd: dict, params: dict, rows: list[tuple[str, str, str]]) -> dict:
    for path, kind, key in rows:
        node = _node(params, path)
        if kind == "leaf":
            sd[key] = _t(node)
        elif kind == "norm":
            _norm(sd, key, node, ("gamma", "beta"))
        else:
            {"dense": _dense, "dense1x1": _dense_as_conv1x1, "conv": _conv1d,
             "conv_t": _conv_t1d}[kind](sd, key, node)
    return sd


def synthesizer_from_jax(params: dict) -> dict:
    """SynthesizerTrn flax params -> port state_dict (upstream
    SynthesizerTrnMs768NSFsid names); an inference tree has no ``enc_q``,
    a training tree carries it."""
    return _fill_rows({}, params, _synth_table(_synth_counts_jax(params)))


def synthesizer_to_jax(state_dict: dict) -> dict:
    """Port SynthesizerTrn state_dict -> the flax parameter tree (numpy fp32,
    flax names), the inverse of :func:`synthesizer_from_jax`; numpy only."""
    sd = {k: np.asarray(v.detach().cpu().float() if torch.is_tensor(v) else v, np.float32)
          for k, v in state_dict.items()}
    tree: dict = {}
    for path, kind, key in _synth_table(_synth_counts_torch(sd)):
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        if kind == "leaf":
            node[leaf] = sd[key]
            continue
        node = node.setdefault(leaf, {})
        if kind == "norm":
            node["scale"], node["bias"] = sd[f"{key}.gamma"], sd[f"{key}.beta"]
            continue
        w = sd[f"{key}.weight"]
        node["kernel"] = np.ascontiguousarray({
            "dense": lambda: w.T,
            "dense1x1": lambda: w[:, :, 0].T,
            "conv": lambda: np.transpose(w, (2, 1, 0)),
            "conv_t": lambda: np.transpose(w, (2, 0, 1))[::-1],
        }[kind]())
        if f"{key}.bias" in sd:
            node["bias"] = sd[f"{key}.bias"]
    return tree


def discriminator_from_jax(params: dict) -> dict:
    """MultiPeriodDiscriminatorV2 flax params -> port state_dict (upstream
    names: ``discriminators.0`` the scale discriminator, then one per period
    in ascending order)."""
    sd: dict = {}
    periods = sorted(int(k[len("disc_p"):]) for k in params if k.startswith("disc_p"))
    for di, (name, conv) in enumerate([("disc_s", _conv1d)]
                                      + [(f"disc_p{p}", _conv2d) for p in periods]):
        node = params[name]
        for j in range(_count(node, "conv_") - 1):
            conv(sd, f"discriminators.{di}.convs.{j}", node[f"conv_{j}"])
        conv(sd, f"discriminators.{di}.conv_post", node["conv_post"])
    return sd


# ---------------------------------------------------------------------- VR

_BN_EPS = 1e-5


def _folded_bn(sd: dict, key: str, node: dict) -> None:
    """A folded batch norm (``x * scale + bias``) as torch BatchNorm state:
    weight = scale, bias = bias, mean 0 and variance 1 - eps, so that the
    eval-mode norm multiplies by scale / sqrt(1 - eps + eps) = scale."""
    _norm(sd, key, node)
    n = np.asarray(node["scale"]).shape[0]
    sd[f"{key}.running_mean"] = torch.zeros(n)
    sd[f"{key}.running_var"] = torch.full((n,), 1.0 - _BN_EPS)
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _vr_cba(sd: dict, key: str, node: dict) -> None:
    _conv2d(sd, f"{key}.conv.0", node["conv"])
    _folded_bn(sd, f"{key}.conv.1", node["bn"])


def _vr_sep_cba(sd: dict, key: str, node: dict) -> None:
    _conv2d(sd, f"{key}.conv.0", node["dw"])
    _conv2d(sd, f"{key}.conv.1", node["pw"])
    _folded_bn(sd, f"{key}.conv.2", node["bn"])


def _vr_base_asppnet(sd: dict, key: str, node: dict) -> None:
    for i in (1, 2, 3, 4):
        _vr_cba(sd, f"{key}.enc{i}.conv1", node[f"enc{i}"]["conv1"])
        _vr_cba(sd, f"{key}.enc{i}.conv2", node[f"enc{i}"]["conv2"])
        _vr_cba(sd, f"{key}.dec{i}.conv", node[f"dec{i}"]["conv"])
    aspp = node["aspp"]
    _vr_cba(sd, f"{key}.aspp.conv1.1", aspp["conv1"])
    _vr_cba(sd, f"{key}.aspp.conv2", aspp["conv2"])
    for i in (3, 4, 5):
        _vr_sep_cba(sd, f"{key}.aspp.conv{i}", aspp[f"conv{i}"])
    _vr_cba(sd, f"{key}.aspp.bottleneck.0", aspp["bottleneck"])


def _lstm(sd: dict, base: str, sfx: str, cell: dict) -> None:
    """A flax LSTM cell (gates i, f, g, o; the bias on the hidden side) as
    torch's packed ``weight_ih/hh`` and ``bias_ih/hh`` of one direction."""
    def w(name):
        return np.asarray(cell[name]["kernel"]).T

    gates = ("i", "f", "g", "o")
    sd[f"{base}.weight_ih_{sfx}"] = _t(np.concatenate([w(f"i{g}") for g in gates]))
    sd[f"{base}.weight_hh_{sfx}"] = _t(np.concatenate([w(f"h{g}") for g in gates]))
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
    sd[f"{base}.bias_ih_{sfx}"] = _t(bias)
    sd[f"{base}.bias_hh_{sfx}"] = _t(np.zeros_like(bias))


def _vr_basenet_new(sd: dict, key: str, node: dict) -> None:
    _vr_cba(sd, f"{key}.enc1", node["enc1"])
    for i in (2, 3, 4, 5):
        _vr_cba(sd, f"{key}.enc{i}.conv1", node[f"enc{i}"]["conv1"])
        _vr_cba(sd, f"{key}.enc{i}.conv2", node[f"enc{i}"]["conv2"])
    aspp = node["aspp"]
    _vr_cba(sd, f"{key}.aspp.conv1.1", aspp["conv1"])
    for i in (2, 3, 4, 5):
        _vr_cba(sd, f"{key}.aspp.conv{i}", aspp[f"conv{i}"])
    _conv2d(sd, f"{key}.aspp.bottleneck", aspp["bottleneck"])
    for i in (1, 2, 3, 4):
        _vr_cba(sd, f"{key}.dec{i}.conv1", node[f"dec{i}"]["conv1"])
    lm = node["lstm_dec2"]
    _vr_cba(sd, f"{key}.lstm_dec2.conv", lm["conv"])
    _lstm(sd, f"{key}.lstm_dec2.lstm", "l0", lm["lstm"]["l0_fwd_cell"])
    _lstm(sd, f"{key}.lstm_dec2.lstm", "l0_reverse", lm["lstm"]["l0_bwd_cell"])
    _dense(sd, f"{key}.lstm_dec2.dense.0", lm["dense"])
    _folded_bn(sd, f"{key}.lstm_dec2.dense.1", lm["dense_bn"])


def vr_from_jax(params: dict) -> dict:
    """CascadedASPPNet or CascadedNet flax params (batch norms folded) ->
    port state_dict (UVR ``.pth`` names).  The auxiliary heads of training,
    which the flax nets do not carry, are zero."""
    sd: dict = {}
    _conv2d(sd, "out", params["out"])
    if "stg2_bridge" in params:
        for name in ("stg1_low_band_net", "stg1_high_band_net", "stg2_full_band_net",
                     "stg3_full_band_net"):
            _vr_base_asppnet(sd, name, params[name])
        _vr_cba(sd, "stg2_bridge", params["stg2_bridge"])
        _vr_cba(sd, "stg3_bridge", params["stg3_bridge"])
        ch = np.asarray(params["stg2_bridge"]["conv"]["kernel"]).shape[2] - 2
        for aux in ("aux1_out", "aux2_out"):
            sd[f"{aux}.weight"] = torch.zeros(2, ch, 1, 1)
        return sd
    _vr_basenet_new(sd, "stg1_low_band_net.0", params["stg1_low_band_net_0"])
    _vr_cba(sd, "stg1_low_band_net.1", params["stg1_low_band_net_1"])
    _vr_basenet_new(sd, "stg1_high_band_net", params["stg1_high_band_net"])
    _vr_basenet_new(sd, "stg2_low_band_net.0", params["stg2_low_band_net_0"])
    _vr_cba(sd, "stg2_low_band_net.1", params["stg2_low_band_net_1"])
    _vr_basenet_new(sd, "stg2_high_band_net", params["stg2_high_band_net"])
    _vr_basenet_new(sd, "stg3_full_band_net", params["stg3_full_band_net"])
    nout = np.asarray(params["out"]["kernel"]).shape[2]
    sd["aux_out.weight"] = torch.zeros(2, 3 * nout // 4, 1, 1)
    return sd


# ---------------------------------------------------------------- HTDemucs

def _weight_bias(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(node["weight"])
    sd[f"{key}.bias"] = _t(node["bias"])


def _htd_coder(sd: dict, key: str, node: dict, freq: bool) -> None:
    conv = _conv2d if freq else _conv1d
    if "conv_tr" in node:
        (_conv_t2d if freq else _conv_t1d)(sd, f"{key}.conv_tr", node["conv_tr"])
    else:
        conv(sd, f"{key}.conv", node["conv"])
    conv(sd, f"{key}.rewrite", node["rewrite"])
    for nrm in ("norm1", "norm2"):
        if nrm in node:
            _weight_bias(sd, f"{key}.{nrm}", node[nrm])
    dc = node.get("dconv", {})
    for d in range(_count(dc, "c1_")):
        b = f"{key}.dconv.layers.{d}"
        _conv1d(sd, f"{b}.0", dc[f"c1_{d}"])
        _weight_bias(sd, f"{b}.1", dc[f"n1_{d}"])
        _conv1d(sd, f"{b}.3", dc[f"c2_{d}"])
        _weight_bias(sd, f"{b}.4", dc[f"n2_{d}"])
        sd[f"{b}.6.scale"] = _t(dc[f"scale_{d}"])


def _htd_tlayer(sd: dict, key: str, node: dict) -> None:
    attn = "cross_attn" if "cross_attn" in node else "self_attn"
    a = node[attn]
    sd[f"{key}.{attn}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(a[q]["kernel"]).T for q in ("q", "k", "v")]))
    sd[f"{key}.{attn}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(a[q]["bias"]) for q in ("q", "k", "v")]))
    _dense(sd, f"{key}.{attn}.out_proj", a["out_proj"])
    for ln in ("norm1", "norm2", "norm3"):
        if ln in node:
            _norm(sd, f"{key}.{ln}", node[ln])
    _weight_bias(sd, f"{key}.norm_out", node["norm_out"])
    _dense(sd, f"{key}.linear1", node["linear1"])
    _dense(sd, f"{key}.linear2", node["linear2"])
    sd[f"{key}.gamma_1.scale"] = _t(node["gamma_1"])
    sd[f"{key}.gamma_2.scale"] = _t(node["gamma_2"])


def htdemucs_from_jax(params: dict) -> dict:
    """HTDemucs flax params -> port state_dict (demucs v4 checkpoint names);
    the inverse of ``convert_htdemucs``."""
    sd: dict = {"freq_emb.embedding.weight": _t(params["freq_emb"])}
    for i in range(_count(params, "encoder_")):
        _htd_coder(sd, f"encoder.{i}", params[f"encoder_{i}"], True)
        _htd_coder(sd, f"tencoder.{i}", params[f"tencoder_{i}"], False)
        _htd_coder(sd, f"decoder.{i}", params[f"decoder_{i}"], True)
        _htd_coder(sd, f"tdecoder.{i}", params[f"tdecoder_{i}"], False)
    for nm in ("channel_upsampler", "channel_upsampler_t", "channel_downsampler",
               "channel_downsampler_t"):
        if nm in params:
            _dense_as_conv1x1(sd, nm, params[nm])
    ct = params["crosstransformer"]
    _norm(sd, "crosstransformer.norm_in", ct["norm_in"])
    _norm(sd, "crosstransformer.norm_in_t", ct["norm_in_t"])
    for idx in range(_count(ct, "layer_t_")):
        _htd_tlayer(sd, f"crosstransformer.layers.{idx}", ct[f"layer_{idx}"])
        _htd_tlayer(sd, f"crosstransformer.layers_t.{idx}", ct[f"layer_t_{idx}"])
    return sd


# ------------------------------------------------------------------ MDX23C

def _mdx23c_stack(sd: dict, key: str, node: dict) -> None:
    """One TFCTDFv3 stack -> ``{key}.blocks.{j}.*``."""
    for j in range(sum(1 for k in node if k.endswith("_shortcut"))):
        b = f"{key}.blocks.{j}"
        _conv2d(sd, f"{b}.shortcut", node[f"b{j}_shortcut"])
        for part in ("tfc1", "tfc2"):
            if f"b{j}_{part}_norm" in node:
                _norm(sd, f"{b}.{part}.0", node[f"b{j}_{part}_norm"]["norm"])
            _conv2d(sd, f"{b}.{part}.2", node[f"b{j}_{part}_conv"])
        if f"b{j}_tdf_norm" in node:
            _norm(sd, f"{b}.tdf.0", node[f"b{j}_tdf_norm"]["norm"])
        _dense(sd, f"{b}.tdf.2", node[f"b{j}_tdf1"])
        _dense(sd, f"{b}.tdf.4", node[f"b{j}_tdf2"])


def mdx23c_from_jax(params: dict) -> dict:
    """TFCTDFNetV3 flax params -> port state_dict (MDX23C ``.ckpt`` names);
    the inverse of ``convert_mdx23c``."""
    sd: dict = {}
    _conv2d(sd, "first_conv", params["first_conv"])
    _conv2d(sd, "final_conv.0", params["final_conv1"])
    _conv2d(sd, "final_conv.2", params["final_conv2"])
    _mdx23c_stack(sd, "bottleneck_block", params["mid"])
    n = _count(params, "enc_")
    for i in range(n):
        d = n - 1 - i           # decoder_blocks run deepest first
        _mdx23c_stack(sd, f"encoder_blocks.{i}.tfc_tdf", params[f"enc_{i}"])
        _mdx23c_stack(sd, f"decoder_blocks.{d}.tfc_tdf", params[f"dec_{i}"])
        if f"down_{i}_norm" in params:
            _norm(sd, f"encoder_blocks.{i}.downscale.0", params[f"down_{i}_norm"]["norm"])
            _norm(sd, f"decoder_blocks.{d}.upscale.0", params[f"up_{i}_norm"]["norm"])
        _conv2d(sd, f"encoder_blocks.{i}.downscale.2", params[f"down_{i}_conv"])
        _conv_t2d(sd, f"decoder_blocks.{d}.upscale.2", params[f"up_{i}_conv"])
    return sd


# ------------------------------------------------------------------ MDXNet

def mdxnet_from_jax(params: dict) -> dict:
    """MDXNet flax params -> port state_dict (the flax module names):
    ``up_*`` transposed convs get their spatial flip back, 4-d kernels are
    convs, 2-d kernels dense layers, GroupNorm scales ``weight``."""
    sd: dict = {}

    def walk(node: dict, key: str) -> None:
        if "kernel" in node:
            kern = np.asarray(node["kernel"])
            if kern.ndim == 2:
                _dense(sd, key, node)
            elif key.rsplit(".", 1)[-1].startswith("up_"):
                _conv_t2d(sd, key, node)
            else:
                _conv2d(sd, key, node)
        elif "scale" in node:
            _norm(sd, key, node)
        else:
            for name, child in node.items():
                walk(child, f"{key}.{name}" if key else name)

    walk(params, "")
    return sd


# ------------------------------------------------------------------ Zonos

def _fourier(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.w"] = _t(node["w"])
    _dense(sd, f"{key}.proj", node["proj"])


def zonos_from_jax(params: dict) -> dict:
    """ZonosModel flax params -> port state_dict: Zyphra's names where
    convert_zonos maps them (fused attention ``mixer.in_proj`` = [wq; wk; wv],
    ``mlp.fc1`` = [w3 (value); w1 (gate)], per-codebook ``embeddings.q``
    split from the offset table, ``heads.q``, ``backbone.norm_f``), mamba_ssm
    names for the Mamba1 mixer, the flax module names for the conditioners."""
    sd: dict = {}
    bk = params["backbone"]
    n_layers = _count(bk, "attn_") + _count(bk, "mamba_")
    for i in range(n_layers):
        p = f"backbone.layers.{i}"
        sd[f"{p}.norm.weight"] = _t(bk[f"norm_{i}"]["weight"])
        sd[f"{p}.norm2.weight"] = _t(bk[f"mlp_norm_{i}"]["weight"])
        mlp = bk[f"mlp_{i}"]
        sd[f"{p}.mlp.fc1.weight"] = _t(np.concatenate(
            [np.asarray(mlp["w3"]["kernel"]).T, np.asarray(mlp["w1"]["kernel"]).T]))
        sd[f"{p}.mlp.fc2.weight"] = _t(np.asarray(mlp["w2"]["kernel"]).T)
        if f"attn_{i}" in bk:
            a = bk[f"attn_{i}"]
            sd[f"{p}.mixer.in_proj.weight"] = _t(np.concatenate(
                [np.asarray(a[w]["kernel"]).T for w in ("wq", "wk", "wv")]))
            sd[f"{p}.mixer.out_proj.weight"] = _t(np.asarray(a["wo"]["kernel"]).T)
            continue
        m, x = bk[f"mamba_{i}"], f"{p}.mixer"
        sd[f"{x}.in_proj.weight"] = _t(np.asarray(m["in_proj"]["kernel"]).T)
        sd[f"{x}.conv1d.weight"] = _t(np.asarray(m["conv_w"]).T[:, None, :])
        sd[f"{x}.conv1d.bias"] = _t(m["conv_b"])
        sd[f"{x}.A_log"] = _t(m["a_log"])
        sd[f"{x}.D"] = _t(m["d_skip"])
        sd[f"{x}.out_proj.weight"] = _t(np.asarray(m["out_proj"]["kernel"]).T)
        if "norm_w" in m:                                       # Mamba2
            sd[f"{x}.dt_bias"] = _t(m["dt_bias"])
            sd[f"{x}.norm.weight"] = _t(m["norm_w"])
        else:
            sd[f"{x}.x_proj.weight"] = _t(np.asarray(m["x_proj"]["kernel"]).T)
            _dense(sd, f"{x}.dt_proj", m["dt_proj"])
    sd["backbone.norm_f.weight"] = _t(bk["final_norm"]["weight"])
    n_q = _count(params, "head_")
    table = np.asarray(params["code_embs"]["embedding"])
    size = table.shape[0] // n_q
    for q in range(n_q):
        sd[f"embeddings.{q}.weight"] = _t(table[q * size:(q + 1) * size])
        sd[f"heads.{q}.weight"] = _t(np.asarray(params[f"head_{q}"]["kernel"]).T)
    sd["text_emb.weight"] = _t(params["text_emb"]["embedding"])
    _dense(sd, "spk_proj", params["spk_proj"])
    for name in ("emotion", "rate", "pitch"):
        _fourier(sd, name, params[name])
    return sd


def dac_from_jax(params: dict) -> dict:
    """DACDecoder flax params -> port state_dict under descript-audio-codec's
    names (the inverse of convert_dac on folded weights)."""
    sd: dict = {}
    for i in range(_count(params, "codebook_")):
        q = f"quantizer.quantizers.{i}"
        sd[f"{q}.codebook.weight"] = _t(params[f"codebook_{i}"]["embedding"])
        _dense_as_conv1x1(sd, f"{q}.out_proj", params[f"out_proj_{i}"])

    def snake(key: str, node: dict) -> None:
        sd[f"{key}.alpha"] = _t(np.asarray(node["alpha"]).reshape(1, -1, 1))

    _conv1d(sd, "decoder.model.0", params["conv_in"])
    n_rates = _count(params, "up_")
    for i in range(n_rates):
        blk = f"decoder.model.{1 + i}.block"
        snake(f"{blk}.0", params[f"snake_{i}"])
        _conv_t1d(sd, f"{blk}.1", params[f"up_{i}"])
        for j in range(3):
            res, node = f"{blk}.{2 + j}.block", params[f"res_{i}_{j}"]
            snake(f"{res}.0", node["s1"])
            _conv1d(sd, f"{res}.1", node["c1"])
            snake(f"{res}.2", node["s2"])
            _conv1d(sd, f"{res}.3", node["c2"])
    snake(f"decoder.model.{1 + n_rates}", params["snake_out"])
    _conv1d(sd, f"decoder.model.{2 + n_rates}", params["conv_out"])
    return sd


def speaker_encoder_from_jax(params: dict) -> dict:
    """SpeakerEncoder flax params -> port state_dict (the flax module names)."""
    sd: dict = {}
    for i in range(_count(params, "conv_")):
        _conv1d(sd, f"conv_{i}", params[f"conv_{i}"])
        _norm(sd, f"ln_{i}", params[f"ln_{i}"])
    _dense(sd, "att", params["att"])
    _dense(sd, "proj", params["proj"])
    return sd


# --------------------------------------------------------------- OpenVoice

def openvoice_from_jax(params: dict) -> dict:
    """ToneColorConverter flax params -> port state_dict under the OpenVoice
    converter checkpoint's names (the names ``convert_openvoice`` reads):
    the reference encoder (LayerNorm, six Conv2d, the GRU in torch's gate
    packing, proj), the posterior encoder and flow by the synthesizer's
    tables, and the plain HiFiGAN decoder."""
    sd: dict = {}
    ref = params["ref_enc"]
    _norm(sd, "ref_enc.layernorm", ref["layernorm"])
    for i in range(_count(ref, "conv_")):
        _conv2d(sd, f"ref_enc.convs.{i}", ref[f"conv_{i}"])
    _gru(sd, "ref_enc.gru", "l0", ref["GRUCell_0"])
    _dense(sd, "ref_enc.proj", ref["proj"])
    enc_q, flow0 = params["enc_q"]["enc"], params["flow"]["flow_0"]["enc"]
    n = dict(flows=_count(params["flow"], "flow_"), flow_layers=_count(flow0, "in_layer_"),
             flow_cond="cond_layer" in flow0, enc_q=_count(enc_q, "in_layer_"),
             enc_q_cond="cond_layer" in enc_q)
    dec = params["dec"]
    ups = _count(dec, "up_")
    kernels = _count(dec, "res_0_")
    rows = _flow_rows(n) + _enc_q_rows(n) + [
        ("dec/conv_pre/Conv_0", "conv", "dec.conv_pre"),
        ("dec/cond", "dense1x1", "dec.cond"),
        ("dec/conv_post/Conv_0", "conv", "dec.conv_post")]
    for i in range(ups):
        rows.append((f"dec/up_{i}/ConvTranspose_0", "conv_t", f"dec.ups.{i}"))
        for j in range(kernels):
            node = dec[f"res_{i}_{j}"]
            for k in range(_count(node, "conv1_")):
                for ours, theirs in (("conv1", "convs1"), ("conv2", "convs2")):
                    rows.append((f"dec/res_{i}_{j}/{ours}_{k}/Conv_0", "conv",
                                 f"dec.resblocks.{i * kernels + j}.{theirs}.{k}"))
    return _fill_rows(sd, params, rows)


# ------------------------------------------------------------------- CREPE

def crepe_from_jax(params: dict, batch_stats: dict) -> dict:
    """Crepe flax params + batch_stats -> port state_dict (torchcrepe
    names: conv1..conv6, conv{i}_BN with running statistics, classifier)."""
    sd: dict = {}
    for i in range(1, _count(params, "conv") // 2 + 1):
        _conv2d(sd, f"conv{i}", params[f"conv{i}"])
        _bn(sd, f"conv{i}_BN", params[f"conv{i}_BN"], batch_stats[f"conv{i}_BN"])
    _dense(sd, "classifier", params["classifier"])
    return sd


# ------------------------------------------------------------- diarization

def diarize_from_jax(seg_params: dict, emb_params: dict) -> tuple[dict, dict]:
    """SegmentationNet and SpeakerEmbedder flax params -> the port modules'
    state_dicts (the flax names; each BiLSTM's ``OptimizedLSTMCell_0`` /
    ``_1`` as torch's forward / reverse direction)."""
    seg: dict = {}
    _conv1d(seg, "conv1", seg_params["conv1"])
    _conv1d(seg, "conv2", seg_params["conv2"])
    for name in ("lstm1", "lstm2"):
        _lstm(seg, name, "l0", seg_params[name]["OptimizedLSTMCell_0"])
        _lstm(seg, name, "l0_reverse", seg_params[name]["OptimizedLSTMCell_1"])
    _dense(seg, "fc1", seg_params["fc1"])
    _dense(seg, "fc2", seg_params["fc2"])
    emb: dict = {}
    for i in range(_count(emb_params, "conv")):
        _conv1d(emb, f"conv{i}", emb_params[f"conv{i}"])
    _dense(emb, "attn", emb_params["attn"])
    _dense(emb, "proj", emb_params["proj"])
    return seg, emb


def _lm_layers(sd: dict, prefix: str, params: dict) -> None:
    """TransformerLM's blocks and final norm under the LLaMA names."""
    for i in range(_count(params, "layer_")):
        p, node = f"{prefix}model.layers.{i}", params[f"layer_{i}"]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                             ("wo", "o_proj")):
            _dense(sd, f"{p}.self_attn.{theirs}", node["attn"][ours])
        for ours, theirs in (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj")):
            _dense(sd, f"{p}.mlp.{theirs}", node["mlp"][ours])
        sd[f"{p}.input_layernorm.weight"] = _t(node["attn_norm"]["weight"])
        sd[f"{p}.post_attention_layernorm.weight"] = _t(node["mlp_norm"]["weight"])
    sd[f"{prefix}model.norm.weight"] = _t(params["final_norm"]["weight"])


def lm_from_jax(params: dict) -> dict:
    """TransformerLM flax params -> port state_dict under HF LLaMA's names
    (the inverse of convert_llama); the embedding and the head only where
    the tree has them."""
    sd: dict = {}
    _lm_layers(sd, "", params)
    if "tok_emb" in params:
        sd["model.embed_tokens.weight"] = _t(params["tok_emb"]["embedding"])
    if "lm_head" in params:
        _dense(sd, "lm_head", params["lm_head"])
    return sd


def dia_from_jax(params: dict, cfg) -> dict:
    """DiaModel flax params -> port state_dict under nari-labs Dia's names and
    DenseGeneral layouts (the inverse of convert_dia): q/k/v kernels (in,
    heads, hd), o (heads, hd, out), ``mlp.wi_fused`` = [w1, w3] on axis 1,
    per-codebook ``decoder.embeddings.Q`` split from the offset table,
    ``decoder.logits_dense`` = the heads stacked on axis 1.  ``cfg`` is the
    model's DiaConfig (for the head counts)."""
    sd: dict = {}

    def attn(key: str, node: dict, heads: int, kv: int) -> None:
        for ours, theirs, h in (("wq", "q_proj", heads), ("wk", "k_proj", kv),
                                ("wv", "v_proj", kv)):
            w = np.asarray(node[ours]["kernel"])
            sd[f"{key}.{theirs}.weight"] = _t(w.reshape(w.shape[0], h, -1))
        w = np.asarray(node["wo"]["kernel"])
        sd[f"{key}.o_proj.weight"] = _t(w.reshape(heads, -1, w.shape[-1]))

    def mlp(key: str, node: dict) -> None:
        sd[f"{key}.wi_fused.weight"] = _t(np.stack(
            [np.asarray(node["w1"]["kernel"]), np.asarray(node["w3"]["kernel"])], axis=1))
        sd[f"{key}.wo.weight"] = _t(node["w2"]["kernel"])

    enc, dec = params["encoder"], params["decoder"]
    sd["encoder.embedding.weight"] = _t(enc["emb"]["embedding"])
    enc_heads = cfg.n_heads_enc or cfg.n_heads // 2
    for i in range(_count(enc, "attn_")):
        b = f"encoder.layers.{i}"
        attn(f"{b}.self_attention", enc[f"attn_{i}"], enc_heads, enc_heads)
        sd[f"{b}.pre_sa_norm.weight"] = _t(enc[f"norm1_{i}"]["weight"])
        sd[f"{b}.post_sa_norm.weight"] = _t(enc[f"norm2_{i}"]["weight"])
        mlp(f"{b}.mlp", enc[f"ffn_{i}"])
    sd["encoder.norm.weight"] = _t(enc["final_norm"]["weight"])
    table = np.asarray(dec["code_emb"]["embedding"])
    size = table.shape[0] // cfg.n_codebooks
    for q in range(cfg.n_codebooks):
        sd[f"decoder.embeddings.{q}.weight"] = _t(table[q * size:(q + 1) * size])
    for i in range(_count(dec, "self_")):
        b = f"decoder.layers.{i}"
        attn(f"{b}.self_attention", dec[f"self_{i}"], cfg.n_heads, cfg.kv_heads or cfg.n_heads)
        attn(f"{b}.cross_attention", dec[f"cross_{i}"], cfg.n_heads, cfg.n_heads)
        for ours, theirs in (("n1", "pre_sa_norm"), ("n2", "pre_ca_norm"),
                             ("n3", "pre_mlp_norm")):
            sd[f"{b}.{theirs}.weight"] = _t(dec[f"{ours}_{i}"]["weight"])
        mlp(f"{b}.mlp", dec[f"ffn_{i}"])
    sd["decoder.norm.weight"] = _t(dec["final_norm"]["weight"])
    sd["decoder.logits_dense.weight"] = _t(np.stack(
        [np.asarray(dec[f"head_{q}"]["kernel"]) for q in range(cfg.n_codebooks)], axis=1))
    return sd


def _conv_inner(sd: dict, key: str, node: dict) -> None:
    """The JAX package's Conv1d / ConvTranspose1d wrappers hold their flax
    layer as ``Conv_0`` / ``ConvTranspose_0``."""
    if "Conv_0" in node:
        _conv1d(sd, key, node["Conv_0"])
    else:
        _conv_t1d(sd, key, node["ConvTranspose_0"])


def bigvgan_from_jax(params: dict, prefix: str = "") -> dict:
    """BigVGAN flax params -> port state_dict (the JAX module's names; snake
    alphas as (1, ch, 1))."""
    sd: dict = {}
    for name, node in params.items():
        if "alpha" in node:
            sd[f"{prefix}{name}.alpha"] = _t(np.asarray(node["alpha"]).reshape(1, -1, 1))
        elif name.startswith("amp_"):
            for sub, leaf in node.items():
                if "alpha" in leaf:
                    sd[f"{prefix}{name}.{sub}.alpha"] = _t(
                        np.asarray(leaf["alpha"]).reshape(1, -1, 1))
                else:
                    _conv_inner(sd, f"{prefix}{name}.{sub}", leaf)
        else:
            _conv_inner(sd, f"{prefix}{name}", node)
    return sd


def xtts_from_jax(params: dict) -> dict:
    """The capability XTTS's flax params {"cond", "gpt", "vocoder"} -> one
    state_dict with ``cond_enc.``, ``gpt.`` and ``vocoder.`` prefixes (the
    JAX module names; the GPT's LM under LLaMA's names, BigVGAN inside the
    vocoder)."""
    sd: dict = {}
    c = params["cond"]
    _conv1d(sd, "cond_enc.conv1", c["conv1"])
    _conv1d(sd, "cond_enc.conv2", c["conv2"])
    _norm(sd, "cond_enc.ln", c["ln"])
    sd["cond_enc.queries"] = _t(c["queries"])
    for name in ("query", "key", "value", "out"):
        sd[f"cond_enc.xattn.{name}.kernel"] = _t(c["xattn"][name]["kernel"])
        sd[f"cond_enc.xattn.{name}.bias"] = _t(c["xattn"][name]["bias"])
    _dense(sd, "cond_enc.ff", c["ff"])
    g = params["gpt"]
    sd["gpt.text_emb.weight"] = _t(g["text_emb"]["embedding"])
    sd["gpt.audio_emb.weight"] = _t(g["audio_emb"]["embedding"])
    _lm_layers(sd, "gpt.lm.", g["lm"])
    _dense(sd, "gpt.audio_head", g["audio_head"])
    v = params["vocoder"]
    sd["vocoder.code_emb.weight"] = _t(v["code_emb"]["embedding"])
    _dense(sd, "vocoder.spk_proj", v["spk_proj"])
    sd.update(bigvgan_from_jax(v["bigvgan"], "vocoder.bigvgan."))
    return sd


def _conv1x1_from_dense(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T[:, :, None])
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def xtts_hifigan_from_jax(params: dict) -> dict:
    """XttsHifiganDecoder flax params -> port state_dict under Coqui's
    ``waveform_decoder`` names (the inverse of convert_xtts_hifigan)."""
    sd: dict = {}
    _conv1d(sd, "conv_pre", params["conv_pre"])
    _conv1x1_from_dense(sd, "cond_layer", params["cond_layer"])
    n_ups = _count(params, "up_")
    n_k = _count(params, "res_0_")
    for i in range(n_ups):
        _conv_t1d(sd, f"ups.{i}", params[f"up_{i}"])
        _conv1x1_from_dense(sd, f"conds.{i}", params[f"cond_{i}"])
        for j in range(n_k):
            res = params[f"res_{i}_{j}"]
            for d in range(_count(res, "c1_")):
                _conv1d(sd, f"resblocks.{i * n_k + j}.convs1.{d}", res[f"c1_{d}"])
                _conv1d(sd, f"resblocks.{i * n_k + j}.convs2.{d}", res[f"c2_{d}"])
    _conv1d(sd, "conv_post", params["conv_post"])
    return sd


def xtts_speaker_from_jax(params: dict, batch_stats: dict) -> dict:
    """XttsSpeakerEncoder flax variables -> port state_dict under Coqui's
    ``speaker_encoder`` names (the inverse of convert_xtts_speaker)."""
    sd: dict = {}
    _conv2d(sd, "conv1", params["conv1"])
    _bn(sd, "bn1", params["bn1"], batch_stats["bn1"])
    for name, node in params.items():
        if not name.startswith("layer"):
            continue
        li, j = name[5:].split("_")
        b, st = f"layer{li}.{j}", batch_stats[name]
        _conv2d(sd, f"{b}.conv1", node["conv1"])
        _bn(sd, f"{b}.bn1", node["bn1"], st["bn1"])
        _conv2d(sd, f"{b}.conv2", node["conv2"])
        _bn(sd, f"{b}.bn2", node["bn2"], st["bn2"])
        _dense(sd, f"{b}.se.fc.0", node["se"]["fc0"])
        _dense(sd, f"{b}.se.fc.2", node["se"]["fc1"])
        if "down_conv" in node:
            _conv2d(sd, f"{b}.downsample.0", node["down_conv"])
            _bn(sd, f"{b}.downsample.1", node["down_bn"], st["down_bn"])
    _conv1x1_from_dense(sd, "attention.0", params["att0"])
    _bn(sd, "attention.2", params["att_bn"], batch_stats["att_bn"])
    _conv1x1_from_dense(sd, "attention.3", params["att1"])
    _dense(sd, "fc", params["fc"])
    return sd


def xtts_gpt2_from_jax(params: dict) -> dict:
    """XttsGPT2 flax params -> port state_dict: the checkpoint's ``gpt.``
    subtree without that prefix (transformers' Conv1D weights (in, out); the
    inverse of convert_xtts_gpt)."""
    sd: dict = {}

    def conv1d(key: str, node: dict) -> None:
        sd[f"{key}.weight"] = _t(node["kernel"])
        sd[f"{key}.bias"] = _t(node["bias"])

    for i in range(_count(params, "h_")):
        b, node = f"gpt.h.{i}", params[f"h_{i}"]
        _norm(sd, f"{b}.ln_1", node["ln_1"])
        conv1d(f"{b}.attn.c_attn", node["c_attn"])
        conv1d(f"{b}.attn.c_proj", node["c_proj_attn"])
        _norm(sd, f"{b}.ln_2", node["ln_2"])
        conv1d(f"{b}.mlp.c_fc", node["c_fc"])
        conv1d(f"{b}.mlp.c_proj", node["c_proj_mlp"])
    _norm(sd, "gpt.ln_f", params["ln_f"])
    _norm(sd, "final_norm", params["final_norm"])
    sd["text_embedding.weight"] = _t(params["text_embedding"]["embedding"])
    sd["mel_embedding.weight"] = _t(params["mel_embedding"]["embedding"])
    sd["text_pos_embedding.emb.weight"] = _t(params["text_pos"])
    sd["mel_pos_embedding.emb.weight"] = _t(params["mel_pos"])
    _dense(sd, "text_head", params["text_head"])
    _dense(sd, "mel_head", params["mel_head"])
    return sd


def xtts_conditioner_from_jax(params: dict) -> dict:
    """XttsConditioningEncoder flax params -> port state_dict under the
    ``conditioning_encoder`` names (the inverse of convert_xtts_conditioner)."""
    sd: dict = {}
    _conv1x1_from_dense(sd, "init", params["init"])
    for i in range(_count(params, "attn_")):
        node = params[f"attn_{i}"]
        _norm(sd, f"attn.{i}.norm", node["norm"])
        _conv1x1_from_dense(sd, f"attn.{i}.qkv", node["qkv"])
        _conv1x1_from_dense(sd, f"attn.{i}.proj_out", node["proj_out"])
    return sd


def xtts_perceiver_from_jax(params: dict) -> dict:
    """XttsPerceiverResampler flax params -> port state_dict under the
    ``conditioning_perceiver`` names (the inverse of convert_xtts_perceiver)."""
    sd: dict = {"latents": _t(params["latents"]), "norm.gamma": _t(params["norm_gamma"])}
    for i in range(_count(params, "q_")):
        b = f"layers.{i}"
        _dense(sd, f"{b}.0.to_q", params[f"q_{i}"])
        _dense(sd, f"{b}.0.to_kv", params[f"kv_{i}"])
        _dense(sd, f"{b}.0.to_out", params[f"out_{i}"])
        _dense(sd, f"{b}.1.0", params[f"ff0_{i}"])
        _dense(sd, f"{b}.1.2", params[f"ff1_{i}"])
    return sd


def xtts_dvae_from_jax(params: dict) -> dict:
    """XttsDVAE flax params -> port state_dict under dvae.pth's Sequential
    names (the inverse of convert_xtts_dvae)."""
    sd: dict = {}
    n_layers, n_res = _count(params, "enc_conv_"), _count(params, "enc_res_")

    def res(key: str, node: dict) -> None:
        for ours, theirs in (("c0", 0), ("c1", 2), ("c2", 4)):
            _conv1d(sd, f"{key}.net.{theirs}", node[ours])

    for i in range(n_layers):
        _conv1d(sd, f"encoder.{i}.0", params[f"enc_conv_{i}"])
    for j in range(n_res):
        res(f"encoder.{n_layers + j}", params[f"enc_res_{j}"])
    _conv1d(sd, f"encoder.{n_layers + n_res}", params["enc_out"])
    sd["codebook.embed"] = _t(params["embed"])
    _conv1d(sd, "decoder.0", params["dec_in"])
    for j in range(n_res):
        res(f"decoder.{1 + j}", params[f"dec_res_{j}"])
    for i in range(n_layers):
        _conv1d(sd, f"decoder.{1 + n_res + i}.0.conv", params[f"dec_up_{i}"])
    _conv1d(sd, f"decoder.{1 + n_res + n_layers}", params["dec_out"])
    return sd


def zonos_prefix_from_jax(params: dict, specs, projection: str = "none") -> dict:
    """ZonosPrefixConditioner flax params -> port state_dict under the
    checkpoint's ``prefix_conditioner`` names (the inverse of
    convert_zonos_prefix)."""
    sd: dict = {}

    def proj(key: str, nm: str, kind: str) -> None:
        if kind == "linear":
            _dense(sd, f"{key}project", params[f"{nm}_proj"])
        elif kind == "mlp":
            _dense(sd, f"{key}project.0", params[f"{nm}_proj0"])
            _dense(sd, f"{key}project.2", params[f"{nm}_proj1"])

    for i, s in enumerate(specs):
        b, nm = f"conditioners.{i}.", f"c_{s.name}"
        if s.uncond_type == "learned":
            sd[f"{b}uncond_vector"] = _t(params[f"{nm}_uncond"])
        if s.type == "EspeakPhonemeConditioner":
            sd[f"{b}phoneme_embedder.weight"] = _t(params[f"{nm}_emb"]["embedding"])
        elif s.type == "FourierConditioner":
            sd[f"{b}weight"] = _t(params[f"{nm}_weight"])
        elif s.type == "IntegerConditioner":
            sd[f"{b}int_embedder.weight"] = _t(params[f"{nm}_emb"]["embedding"])
        proj(b, nm, s.projection)
    proj("", "prefix", projection)
    _norm(sd, "norm", params["norm"])
    return sd


# ------------------------------------------------------------- Chatterbox

def chatterbox_t3_from_jax(params: dict) -> dict:
    """T3 flax params -> port state_dict under t3_cfg.safetensors' names (the
    inverse of convert_chatterbox_t3): the LLaMA backbone as ``tfmr.layers.N``
    and ``tfmr.norm``, the position tables as ``*_pos_emb.emb``, the
    perceiver's ``attn.to_out.0``."""
    sd: dict = {}
    for name in ("text_emb", "speech_emb"):
        sd[f"{name}.weight"] = _t(params[name]["embedding"])
    for name in ("text_pos_emb", "speech_pos_emb"):
        sd[f"{name}.emb.weight"] = _t(params[name]["embedding"])
    for name in ("text_head", "speech_head"):
        _dense(sd, name, params[name])
    ce = params["cond_enc"]
    _dense(sd, "cond_enc.spkr_enc", ce["spkr_enc"])
    _dense(sd, "cond_enc.emotion_adv_fc", ce["emotion_adv_fc"])
    p = ce["perceiver"]
    sd["cond_enc.perceiver.pre_attention_query"] = _t(p["pre_attention_query"])
    for proj in ("to_q", "to_k", "to_v"):
        _dense(sd, f"cond_enc.perceiver.attn.{proj}", p["attn"][proj])
    _dense(sd, "cond_enc.perceiver.attn.to_out.0", p["attn"]["to_out"])
    lm: dict = {}
    _lm_layers(lm, "", params["tfmr"])
    sd.update({f"tfmr.{k[len('model.'):]}": v for k, v in lm.items()})
    return sd


def voice_encoder_from_jax(params: dict) -> dict:
    """VoiceEncoder flax params -> port state_dict under ve.safetensors' names
    (torch LSTM weights (4h, in) in gate order i, f, g, o; ``proj``)."""
    sd: dict = {}
    for i in range(_count(params, "lstm_l")):
        node = params[f"lstm_l{i}"]
        sd[f"lstm.weight_ih_l{i}"] = _t(np.asarray(node["w_ih"]).T)
        sd[f"lstm.weight_hh_l{i}"] = _t(np.asarray(node["w_hh"]).T)
        sd[f"lstm.bias_ih_l{i}"] = _t(node["b_ih"])
        sd[f"lstm.bias_hh_l{i}"] = _t(node["b_hh"])
    _dense(sd, "proj", params["proj"])
    return sd


def _s3gen_causal_block(sd: dict, key: str, node: dict) -> None:
    _conv1d(sd, f"{key}.block.0", node["conv"]["conv"]["Conv_0"])
    _norm(sd, f"{key}.block.2", node["norm"])


def _s3gen_resnet_block(sd: dict, key: str, node: dict) -> None:
    _dense(sd, f"{key}.mlp.1", node["mlp"])
    _s3gen_causal_block(sd, f"{key}.block1", node["block1"])
    _s3gen_causal_block(sd, f"{key}.block2", node["block2"])
    _conv1d(sd, f"{key}.res_conv", node["res_conv"]["Conv_0"])


def _s3gen_transformer_block(sd: dict, key: str, node: dict) -> None:
    for proj in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{key}.attn1.{proj}", node[proj])
    _dense(sd, f"{key}.attn1.to_out.0", node["to_out"])
    _norm(sd, f"{key}.norm1", node["norm1"])
    _norm(sd, f"{key}.norm3", node["norm3"])
    _dense(sd, f"{key}.ff.net.0.proj", node["ff_in"])
    _dense(sd, f"{key}.ff.net.2", node["ff_out"])


def s3gen_flow_from_jax(params: dict, prefix: str = "") -> dict:
    """CausalMaskedDiffWithXvec flax params -> port state_dict under
    s3gen.safetensors' ``flow.*`` names (without the ``flow.`` unless given
    as ``prefix``; the inverse of convert_s3gen_flow)."""
    sd: dict = {}
    p = prefix
    sd[f"{p}input_embedding.weight"] = _t(params["input_embedding"]["embedding"])
    for lin in ("spk_embed_affine_layer", "encoder_proj"):
        _dense(sd, f"{p}{lin}", params[lin])
    enc = params["encoder"]
    for emb in ("embed", "up_embed"):
        _dense(sd, f"{p}encoder.{emb}.out.0", enc[emb]["out0"])
        _norm(sd, f"{p}encoder.{emb}.out.1", enc[emb]["out1"])
    for conv in ("conv1", "conv2"):
        _conv1d(sd, f"{p}encoder.pre_lookahead_layer.{conv}",
                enc["pre_lookahead_layer"][conv]["Conv_0"])
    _conv1d(sd, f"{p}encoder.up_layer.conv", enc["up_layer"]["conv"]["Conv_0"])
    for group in ("encoders", "up_encoders"):
        for i in range(_count(enc, f"{group}_")):
            node, key = enc[f"{group}_{i}"], f"{p}encoder.{group}.{i}"
            a = node["self_attn"]
            for proj in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
                _dense(sd, f"{key}.self_attn.{proj}", a[proj])
            sd[f"{key}.self_attn.pos_bias_u"] = _t(a["pos_bias_u"])
            sd[f"{key}.self_attn.pos_bias_v"] = _t(a["pos_bias_v"])
            _dense(sd, f"{key}.feed_forward.w_1", node["ffn_w1"])
            _dense(sd, f"{key}.feed_forward.w_2", node["ffn_w2"])
            _norm(sd, f"{key}.norm_mha", node["norm_mha"])
            _norm(sd, f"{key}.norm_ff", node["norm_ff"])
    _norm(sd, f"{p}encoder.after_norm", enc["after_norm"])
    est, te = params["decoder"]["estimator"], f"{p}decoder.estimator"
    _dense(sd, f"{te}.time_mlp.linear_1", est["time_mlp_1"])
    _dense(sd, f"{te}.time_mlp.linear_2", est["time_mlp_2"])
    n_tb = _count(est, "down_tb_")
    _s3gen_resnet_block(sd, f"{te}.down_blocks.0.0", est["down_resnet"])
    for i in range(n_tb):
        _s3gen_transformer_block(sd, f"{te}.down_blocks.0.1.{i}", est[f"down_tb_{i}"])
    _conv1d(sd, f"{te}.down_blocks.0.2", est["downsample"]["conv"]["Conv_0"])
    for m in range(_count(est, "mid_resnet_")):
        _s3gen_resnet_block(sd, f"{te}.mid_blocks.{m}.0", est[f"mid_resnet_{m}"])
        for i in range(n_tb):
            _s3gen_transformer_block(sd, f"{te}.mid_blocks.{m}.1.{i}", est[f"mid_tb_{m}_{i}"])
    _s3gen_resnet_block(sd, f"{te}.up_blocks.0.0", est["up_resnet"])
    for i in range(n_tb):
        _s3gen_transformer_block(sd, f"{te}.up_blocks.0.1.{i}", est[f"up_tb_{i}"])
    _conv1d(sd, f"{te}.up_blocks.0.2", est["upsample"]["conv"]["Conv_0"])
    _s3gen_causal_block(sd, f"{te}.final_block", est["final_block"])
    _conv1d(sd, f"{te}.final_proj", est["final_proj"]["Conv_0"])
    return sd


def hift_from_jax(params: dict, prefix: str = "") -> dict:
    """HiFTGenerator flax params -> port state_dict under s3gen.safetensors'
    ``mel2wav.*`` names (without the ``mel2wav.`` unless given as
    ``prefix``; weight-normed convolutions as their folded ``.weight``;
    the inverse of convert_hift)."""
    sd: dict = {}
    p = prefix
    for i in range(_count(params["f0_predictor"], "condnet_")):
        _conv_inner(sd, f"{p}f0_predictor.condnet.{2 * i}",
                    params["f0_predictor"][f"condnet_{i}"])
    _dense(sd, f"{p}f0_predictor.classifier", params["f0_predictor"]["classifier"])
    _dense(sd, f"{p}m_source.l_linear", params["m_source_linear"])
    for conv in ("conv_pre", "conv_post"):
        _conv_inner(sd, f"{p}{conv}", params[conv])

    def resblock(key: str, node: dict) -> None:
        for j in range(_count(node, "convs1_")):
            _conv_inner(sd, f"{key}.convs1.{j}", node[f"convs1_{j}"])
            _conv_inner(sd, f"{key}.convs2.{j}", node[f"convs2_{j}"])
            sd[f"{key}.activations1.{j}.alpha"] = _t(node[f"act1_{j}"]["alpha"])
            sd[f"{key}.activations2.{j}.alpha"] = _t(node[f"act2_{j}"]["alpha"])

    n_up = _count(params, "ups_")
    n_k = _count(params, "resblocks_") // n_up
    for i in range(n_up):
        _conv_inner(sd, f"{p}ups.{i}", params[f"ups_{i}"])
        _conv_inner(sd, f"{p}source_downs.{i}", params[f"source_downs_{i}"])
        resblock(f"{p}source_resblocks.{i}", params[f"source_resblocks_{i}"])
        for j in range(n_k):
            resblock(f"{p}resblocks.{i * n_k + j}", params[f"resblocks_{i}_{j}"])
    return sd


def _bn_params(sd: dict, key: str, node: dict) -> None:
    """The JAX package's BNInfer (running statistics held as parameters,
    ``mean`` / ``var``, and the affine where it has one) as torch BatchNorm
    state."""
    if "scale" in node:
        _norm(sd, key, node)
    sd[f"{key}.running_mean"] = _t(node["mean"])
    sd[f"{key}.running_var"] = _t(node["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def campplus_from_jax(params: dict) -> dict:
    """CAMPPlus flax params -> port state_dict under 3D-Speaker's names (the
    s3gen.safetensors ``speaker_encoder.*`` subtree without its prefix; the
    inverse of convert_campplus).  The JAX tree has no ``batch_stats``:
    its BNInfer keeps the running statistics among the parameters."""
    sd: dict = {}
    head = params["head"]
    _conv2d(sd, "head.conv1", head["conv1"])
    _bn_params(sd, "head.bn1", head["bn1"])
    for layer in ("layer1", "layer2"):
        for bi in range(2):
            node, key = head[f"{layer}_{bi}"], f"head.{layer}.{bi}"
            _conv2d(sd, f"{key}.conv1", node["conv1"])
            _bn_params(sd, f"{key}.bn1", node["bn1"])
            _conv2d(sd, f"{key}.conv2", node["conv2"])
            _bn_params(sd, f"{key}.bn2", node["bn2"])
            if "shortcut_conv" in node:
                _conv2d(sd, f"{key}.shortcut.0", node["shortcut_conv"])
                _bn_params(sd, f"{key}.shortcut.1", node["shortcut_bn"])
    _conv2d(sd, "head.conv2", head["conv2"])
    _bn_params(sd, "head.bn2", head["bn2"])
    _conv1d(sd, "xvector.tdnn.linear", params["tdnn_linear"]["Conv_0"])
    _bn_params(sd, "xvector.tdnn.nonlinear.batchnorm", params["tdnn_nonlinear"]["batchnorm"])
    for name, node in params.items():
        m = re.fullmatch(r"block(\d+)_tdnnd(\d+)", name)
        if not m:
            continue
        key = f"xvector.block{m.group(1)}.tdnnd{m.group(2)}"
        _bn_params(sd, f"{key}.nonlinear1.batchnorm", node["nonlinear1"]["batchnorm"])
        _conv1d(sd, f"{key}.linear1", node["linear1"]["Conv_0"])
        _bn_params(sd, f"{key}.nonlinear2.batchnorm", node["nonlinear2"]["batchnorm"])
        for conv in ("linear_local", "linear1", "linear2"):
            _conv1d(sd, f"{key}.cam_layer.{conv}", node["cam_layer"][conv]["Conv_0"])
    for b in range(1, _count(params, "transit") // 2 + 1):
        _bn_params(sd, f"xvector.transit{b}.nonlinear.batchnorm",
                   params[f"transit{b}_nonlinear"]["batchnorm"])
        _conv1d(sd, f"xvector.transit{b}.linear", params[f"transit{b}_linear"]["Conv_0"])
    _bn_params(sd, "xvector.out_nonlinear.batchnorm", params["out_nonlinear"]["batchnorm"])
    sd["xvector.dense.linear.weight"] = _t(
        np.asarray(params["dense_linear"]["kernel"]).T[:, :, None])
    _bn_params(sd, "xvector.dense.nonlinear.batchnorm", params["dense_nonlinear"])
    return sd


def s3tokenizer_from_jax(params: dict) -> dict:
    """S3TokenizerV2 flax params -> port state_dict under the s3tokenizer
    package's names (the s3gen.safetensors ``tokenizer.*`` subtree without
    its prefix; the FSQ at ``quantizer.vq``; the inverse of
    convert_s3tokenizer)."""
    sd: dict = {}
    enc = params["encoder"]
    _conv1d(sd, "encoder.conv1", enc["conv1"])
    _conv1d(sd, "encoder.conv2", enc["conv2"])
    for i in range(_count(enc, "block_")):
        node, key = enc[f"block_{i}"], f"encoder.blocks.{i}"
        for proj in ("query", "key", "value", "out"):
            _dense(sd, f"{key}.attn.{proj}", node["attn"][proj])
        sd[f"{key}.attn.fsmn_block.weight"] = _t(
            np.asarray(node["attn"]["fsmn_kernel"]).T[:, None, :])
        _norm(sd, f"{key}.attn_ln", node["attn_ln"])
        _norm(sd, f"{key}.mlp_ln", node["mlp_ln"])
        _dense(sd, f"{key}.mlp.0", node["mlp_0"])
        _dense(sd, f"{key}.mlp.2", node["mlp_2"])
    _norm(sd, "encoder.ln_post", enc["ln_post"])
    _dense(sd, "quantizer.vq.project_down", params["project_down"])
    return sd


def wespeaker_from_jax(params: dict) -> dict:
    """WeSpeakerResNet flax params -> port state_dict under wespeaker's names
    (the inverse of convert_wespeaker).  The JAX package holds each
    BatchNorm folded into a per-channel affine: it comes back as a norm of
    mean 0 and variance 1 - eps with the affine as its weight and bias;
    ``seg_bn_1`` (no affine) as the running statistics that fold to it."""
    sd: dict = {}
    _conv2d(sd, "conv1", params["conv1"])
    _folded_bn(sd, "bn1", params["bn1"])
    for name, node in params.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if not m:
            continue
        key = f"layer{m.group(1)}.{m.group(2)}"
        _conv2d(sd, f"{key}.conv1", node["conv1"])
        _folded_bn(sd, f"{key}.bn1", node["bn1"])
        _conv2d(sd, f"{key}.conv2", node["conv2"])
        _folded_bn(sd, f"{key}.bn2", node["bn2"])
        if "short_conv" in node:
            _conv2d(sd, f"{key}.shortcut.0", node["short_conv"])
            _folded_bn(sd, f"{key}.shortcut.1", node["short_bn"])
    _dense(sd, "seg_1", params["seg_1"])
    if "seg_2" in params:
        scale = np.asarray(params["seg_bn_1"]["scale"], np.float64)
        bias = np.asarray(params["seg_bn_1"]["bias"], np.float64)
        sd["seg_bn_1.running_mean"] = _t(-bias / scale)
        sd["seg_bn_1.running_var"] = _t(1.0 / scale ** 2 - _BN_EPS)
        sd["seg_bn_1.num_batches_tracked"] = torch.tensor(0)
        _dense(sd, "seg_2", params["seg_2"])
    return sd


# ------------------------------------------------------------------ listening

def _whisper_block(sd: dict, key: str, node: dict) -> None:
    for ours, theirs in (("wq", "query"), ("wk", "key"), ("wv", "value"), ("wo", "out")):
        _dense(sd, f"{key}.attn.{theirs}", node[ours])
    _norm(sd, f"{key}.attn_ln", node["attn_ln"])
    if "cq" in node:
        for ours, theirs in (("cq", "query"), ("ck", "key"), ("cv", "value"), ("co", "out")):
            _dense(sd, f"{key}.cross_attn.{theirs}", node[ours])
        _norm(sd, f"{key}.cross_attn_ln", node["cross_ln"])
    _dense(sd, f"{key}.mlp.0", node["fc1"])
    _dense(sd, f"{key}.mlp.2", node["fc2"])
    _norm(sd, f"{key}.mlp_ln", node["mlp_ln"])


def whisper_from_jax(params: dict) -> dict:
    """WhisperModel flax params -> port state_dict (openai-whisper names)."""
    sd: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv1d(sd, "encoder.conv1", enc["conv1"])
    _conv1d(sd, "encoder.conv2", enc["conv2"])
    for i in range(_count(enc, "block_")):
        _whisper_block(sd, f"encoder.blocks.{i}", enc[f"block_{i}"])
    _norm(sd, "encoder.ln_post", enc["ln_post"])
    sd["decoder.token_embedding.weight"] = _t(dec["emb"]["embedding"])
    sd["decoder.positional_embedding"] = _t(dec["pos"])
    for i in range(_count(dec, "block_")):
        _whisper_block(sd, f"decoder.blocks.{i}", dec[f"block_{i}"])
    _norm(sd, "decoder.ln", dec["ln"])
    return sd


def wav2vec2_from_jax(params: dict) -> dict:
    """Wav2Vec2CTC flax params -> port state_dict: the HuBERT encoder under
    ``encoder.`` (fairseq names) and ``lm_head``."""
    sd = {f"encoder.{k}": v for k, v in hubert_from_jax(params["encoder"]).items()}
    _dense(sd, "lm_head", params["lm_head"])
    return sd


_W2V_HF = (
    (r"^encoder\.feature_extractor\.conv_layers\.(\d+)\.0\.",
     r"wav2vec2.feature_extractor.conv_layers.\1.conv."),
    (r"^encoder\.feature_extractor\.conv_layers\.0\.2\.",
     "wav2vec2.feature_extractor.conv_layers.0.layer_norm."),
    (r"^encoder\.layer_norm\.", "wav2vec2.feature_projection.layer_norm."),
    (r"^encoder\.post_extract_proj\.", "wav2vec2.feature_projection.projection."),
    (r"^encoder\.encoder\.pos_conv\.0\.", "wav2vec2.encoder.pos_conv_embed.conv."),
    (r"^encoder\.encoder\.layer_norm\.", "wav2vec2.encoder.layer_norm."),
    (r"^encoder\.encoder\.layers\.(\d+)\.self_attn\.(\w+)\.",
     r"wav2vec2.encoder.layers.\1.attention.\2."),
    (r"^encoder\.encoder\.layers\.(\d+)\.self_attn_layer_norm\.",
     r"wav2vec2.encoder.layers.\1.layer_norm."),
    (r"^encoder\.encoder\.layers\.(\d+)\.fc1\.",
     r"wav2vec2.encoder.layers.\1.feed_forward.intermediate_dense."),
    (r"^encoder\.encoder\.layers\.(\d+)\.fc2\.",
     r"wav2vec2.encoder.layers.\1.feed_forward.output_dense."),
    (r"^encoder\.encoder\.layers\.(\d+)\.final_layer_norm\.",
     r"wav2vec2.encoder.layers.\1.final_layer_norm."),
)


def wav2vec2_to_hf(state_dict: dict) -> dict:
    """The port's Wav2Vec2CTC state_dict under HF ``Wav2Vec2ForCTC``'s names
    (the names ``convert_wav2vec2`` reads; ``lm_head`` keeps its own)."""
    out = {}
    for k, v in state_dict.items():
        for pat, rep in _W2V_HF:
            k2 = re.sub(pat, rep, k)
            if k2 != k:
                k = k2
                break
        out[k] = v
    return out


def pyannet_from_jax(params: dict) -> dict:
    """PyanNet flax params -> port state_dict (pyannote segmentation-3.0
    names; each LSTM direction one flax ``OptimizedLSTMCell``)."""
    sd: dict = {}
    sn = params["sincnet"]
    sd["sincnet.wav_norm1d.weight"] = _t(sn["wav_norm"]["weight"])
    sd["sincnet.wav_norm1d.bias"] = _t(sn["wav_norm"]["bias"])
    sd["sincnet.conv1d.0.filterbank.low_hz_"] = _t(sn["sinc"]["low_hz"])
    sd["sincnet.conv1d.0.filterbank.band_hz_"] = _t(sn["sinc"]["band_hz"])
    for i in (1, 2):
        _conv1d(sd, f"sincnet.conv1d.{i}", sn[f"conv_{i}"])
    for i in (0, 1, 2):
        sd[f"sincnet.norm1d.{i}.weight"] = _t(sn[f"norm_{i}"]["weight"])
        sd[f"sincnet.norm1d.{i}.bias"] = _t(sn[f"norm_{i}"]["bias"])
    lstm = params["lstm"]
    for k in range(_count(lstm, "l") // 2):
        _lstm(sd, "lstm", f"l{k}", lstm[f"l{k}_fwd_cell"])
        _lstm(sd, "lstm", f"l{k}_reverse", lstm[f"l{k}_bwd_cell"])
    for i in (0, 1):
        _dense(sd, f"linear.{i}", params[f"linear_{i}"])
    _dense(sd, "classifier", params["classifier"])
    return sd


def crnn_from_jax(params: dict) -> dict:
    """RTLA CRNN flax params -> port state_dict (the flax names)."""
    sd: dict = {}
    for i in range(_count(params, "conv_")):
        _conv2d(sd, f"conv_{i}", params[f"conv_{i}"])
        _norm(sd, f"ln_{i}", params[f"ln_{i}"])
    for g in ("wz", "wr", "wn"):
        _dense(sd, f"gru.{g}", params["gru"][g])
    _dense(sd, "head", params["head"])
    return sd


def rtla_crnn_from_jax(params: dict) -> dict:
    """RtlaCRNN flax params -> port state_dict (the RTLA checkpoint's
    names).  Each folded affine becomes a BatchNorm with mean 0 and variance
    1 - eps, whose eval normalisation divides by sqrt(1) (fp32 rounding)."""
    sd: dict = {}
    for i, (conv, bn) in enumerate(((0, 1), (3, 4), (8, 9))):
        _conv2d(sd, f"model.0.cnn.{conv}", params[f"conv_{i}"])
        node, key = params[f"bn_{i}"], f"model.0.cnn.{bn}"
        _norm(sd, key, node)
        sd[f"{key}.running_mean"] = torch.zeros(np.asarray(node["scale"]).shape)
        sd[f"{key}.running_var"] = torch.full(np.asarray(node["scale"]).shape, 1.0 - 1e-5)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    _dense(sd, "model.0.fc.0", params["fc"])
    _lstm(sd, "model.1.rnn", "l0", params["lstm_cell"])
    _dense(sd, "model.2", params["head"])
    return sd


# ------------------------------------------------- WaveGrad, BDDM, AudioSR

def _by_rank(sd: dict, key: str, node: dict) -> None:
    """A flax tree of Conv (3-D kernel) and Dense (2-D kernel) leaves, under
    the flax names joined by ``.``."""
    if "kernel" in node:
        (_conv1d if np.ndim(node["kernel"]) == 3 else _dense)(sd, key, node)
        return
    for name, child in node.items():
        _by_rank(sd, f"{key}.{name}" if key else name, child)


def wavegrad_from_jax(params: dict) -> dict:
    """WaveGrad flax params -> port state_dict (the flax names: WaveGrad has
    no upstream checkpoint layout)."""
    sd: dict = {}
    _by_rank(sd, "", params)
    return sd


def bddm_from_jax(params: dict) -> dict:
    """BDDMScheduleNet flax params -> port state_dict (``Conv_0..2``,
    ``ratio``)."""
    sd: dict = {}
    _by_rank(sd, "", params)
    return sd


def _vae_res(sd: dict, key: str, node: dict) -> None:
    for n in ("norm1", "norm2"):
        _norm(sd, f"{key}.{n}", node[n])
    for c in ("conv1", "conv2", "nin_shortcut"):
        if c in node:
            _conv2d(sd, f"{key}.{c}", node[c])


def audiosr_vae_from_jax(params: dict) -> dict:
    """AudioSRVAE flax params -> port state_dict (the audiosr
    ``first_stage_model`` names, the inverse of ``audiosr_vae_mapping``)."""
    sd: dict = {}
    for side in ("encoder", "decoder"):
        s = params[side]
        for c in ("conv_in", "conv_out"):
            _conv2d(sd, f"{side}.{c}", s[c])
        _norm(sd, f"{side}.norm_out", s["norm_out"])
        _vae_res(sd, f"{side}.mid.block_1", s["mid_1"])
        _vae_res(sd, f"{side}.mid.block_2", s["mid_2"])
        _norm(sd, f"{side}.mid.attn_1.norm", s["mid_attn"]["norm"])
        for p in ("q", "k", "v", "proj_out"):
            _conv2d(sd, f"{side}.mid.attn_1.{p}", s["mid_attn"][p])
        for name, node in s.items():
            parts = name.split("_")
            if parts[0] not in ("down", "up") or len(parts) != 3:
                continue
            li, bi = parts[1], parts[2]
            if bi == "ds":
                _conv2d(sd, f"{side}.down.{li}.downsample.conv", node)
            elif bi == "us":
                _conv2d(sd, f"{side}.up.{li}.upsample.conv", node)
            else:
                _vae_res(sd, f"{side}.{parts[0]}.{li}.block.{bi}", node)
    _conv2d(sd, "quant_conv", params["quant_conv"])
    _conv2d(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def _unet_res(sd: dict, key: str, node: dict) -> None:
    _norm(sd, f"{key}.in_layers.0", node["norm_in"])
    _conv2d(sd, f"{key}.in_layers.2", node["conv_in"])
    _dense(sd, f"{key}.emb_layers.1", node["emb"])
    _norm(sd, f"{key}.out_layers.0", node["norm_out"])
    _conv2d(sd, f"{key}.out_layers.3", node["conv_out"])
    if "skip" in node:
        _conv2d(sd, f"{key}.skip_connection", node["skip"])


def _unet_attn(sd: dict, key: str, node: dict) -> None:
    _norm(sd, f"{key}.norm", node["norm"])
    _conv2d(sd, f"{key}.proj_in", node["proj_in"])
    _conv2d(sd, f"{key}.proj_out", node["proj_out"])
    tb = f"{key}.transformer_blocks.0"
    for a in ("attn1", "attn2"):
        for p in ("q", "k", "v"):
            _dense(sd, f"{tb}.{a}.to_{p}", node[f"{a}_{p}"])
        _dense(sd, f"{tb}.{a}.to_out.0", node[f"{a}_out"])
    for i in (1, 2, 3):
        _norm(sd, f"{tb}.norm{i}", node[f"norm{i}"])
    _dense(sd, f"{tb}.ff.net.0.proj", node["ff0"])
    _dense(sd, f"{tb}.ff.net.2", node["ff1"])


def audiosr_unet_from_jax(params: dict, cfg=None) -> dict:
    """AudioSRUNet flax params -> port state_dict (the audiosr
    ``model.diffusion_model`` names), walking the same
    ``unet_layer_schedule`` as the modules and ``audiosr_unet_mapping``."""
    from audiolab_tpu_torch.models.audiosr_unet import AudioSRUNetConfig, unet_layer_schedule

    sd: dict = {}
    _dense(sd, "time_embed.0", params["time_0"])
    _dense(sd, "time_embed.2", params["time_2"])
    inputs, middle, outputs = unet_layer_schedule(cfg or AudioSRUNetConfig())
    blocks = ([(f"in_{i}", f"input_blocks.{i}", b) for i, b in enumerate(inputs)]
              + [("mid", "middle_block", middle)]
              + [(f"out_{i}", f"output_blocks.{i}", b) for i, b in enumerate(outputs)])
    for prefix, tkey, layers in blocks:
        for j, (kind, _p) in enumerate(layers):
            node, key = params[f"{prefix}_{j}"], f"{tkey}.{j}"
            if kind == "res":
                _unet_res(sd, key, node)
            elif kind == "attn":
                _unet_attn(sd, key, node)
            else:
                _conv2d(sd, {"conv_in": key, "down": f"{key}.op", "up": f"{key}.conv"}[kind],
                        node)
    _norm(sd, "out.0", params["norm_out"])
    _conv2d(sd, "out.2", params["conv_out"])
    return sd


def audiosr_vocoder_from_jax(params: dict) -> dict:
    """AudioSRVocoder flax params -> port state_dict (the audiosr 48k
    vocoder names, weight norms folded)."""
    sd: dict = {}
    _conv1d(sd, "conv_pre", params["conv_pre"])
    _conv1d(sd, "conv_post", params["conv_post"])
    n_kernels = _count(params, "res_0_")
    for i in range(_count(params, "up_")):
        _conv_t1d(sd, f"ups.{i}", params[f"up_{i}"])
        for j in range(n_kernels):
            res = params[f"res_{i}_{j}"]
            for d in range(_count(res, "c1_")):
                key = f"resblocks.{i * n_kernels + j}"
                _conv1d(sd, f"{key}.convs1.{d}", res[f"c1_{d}"])
                _conv1d(sd, f"{key}.convs2.{d}", res[f"c2_{d}"])
    return sd


# ------------------------------------------------ music: DiT, Stable Audio, ACE-Step

def _flax_walk(sd: dict, key: str, node, conv_t: tuple = ()) -> None:
    """A flax tree under its names joined by ``.``: Dense and Conv kernels
    (transposed convolutions where the module name starts with one of
    ``conv_t``), norms' scale and bias as weight and bias, embeddings, and
    ``MultiHeadDotProductAttention``'s (dim, heads, head_dim) query, key and
    value and (heads, head_dim, dim) ``out`` as Linears over heads * head_dim.
    A Snake's (ch,) ``alpha`` becomes the port's (1, ch, 1); other leaves are
    taken as they are."""
    leaf = key.rsplit(".", 1)[-1]
    if "kernel" in node:
        k = np.asarray(node["kernel"])
        if leaf in ("query", "key", "value"):
            sd[f"{key}.weight"] = _t(k.reshape(k.shape[0], -1).T)
            sd[f"{key}.bias"] = _t(np.asarray(node["bias"]).reshape(-1))
        elif leaf == "out" and k.ndim == 3:
            sd[f"{key}.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
            sd[f"{key}.bias"] = _t(node["bias"])
        elif k.ndim == 3:
            (_conv_t1d if leaf.startswith(conv_t) else _conv1d)(sd, key, node)
        else:
            _dense(sd, key, node)
        return
    if "scale" in node:
        _norm(sd, key, node)
        return
    if "embedding" in node:
        sd[f"{key}.weight"] = _t(node["embedding"])
        return
    for name, child in node.items():
        sub = f"{key}.{name}" if key else name
        if isinstance(child, dict):
            _flax_walk(sd, sub, child, conv_t)
        else:
            arr = np.asarray(child)
            sd[sub] = _t(arr.reshape(1, -1, 1) if name == "alpha" else arr)


def dit_from_jax(params: dict) -> dict:
    """DiT flax params -> port state_dict (the flax names: the in-repo DiT has
    no upstream checkpoint layout)."""
    sd: dict = {}
    _flax_walk(sd, "", params)
    return sd


def stable_audio_from_jax(params: dict) -> dict:
    """StableAudioModel flax params -> port state_dict (the flax names; the
    decoder's ``up_N`` are transposed convolutions)."""
    sd: dict = {}
    _flax_walk(sd, "", params, conv_t=("up_",))
    return sd


def acestep_from_jax(params: dict) -> dict:
    """ACEStepModel flax params -> port state_dict (the flax names; the DCAE
    decoder's ``up_N`` are transposed convolutions)."""
    sd: dict = {}
    _flax_walk(sd, "", params, conv_t=("up_",))
    return sd


def t5_from_jax(params: dict) -> dict:
    """T5Encoder flax params -> port state_dict (transformers'
    ``T5EncoderModel`` names, the inverse of ``t5_mapping``)."""
    sd: dict = {"shared.weight": _t(params["emb"]["embedding"]),
                "encoder.final_layer_norm.weight": _t(params["final_ln"]["weight"])}
    for i in range(_count(params, "attn_")):
        b = f"encoder.block.{i}.layer"
        rel = params.get(f"rel_bias_{i}") or (params.get("rel_bias") if i == 0 else None)
        if rel is not None:
            sd[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = _t(rel["embedding"])
        sd[f"{b}.0.layer_norm.weight"] = _t(params[f"ln1_{i}"]["weight"])
        sd[f"{b}.1.layer_norm.weight"] = _t(params[f"ln2_{i}"]["weight"])
        for p in ("q", "k", "v", "o"):
            _dense(sd, f"{b}.0.SelfAttention.{p}", params[f"attn_{i}"][p])
        for name, node in params[f"ffn_{i}"].items():
            _dense(sd, f"{b}.1.DenseReluDense.{name}", node)
    return sd


def number_embedder_from_jax(params: dict) -> dict:
    """NumberEmbedder flax params -> port state_dict (the stable-audio
    checkpoint's ``embedding.0.weights``, ``embedding.1``)."""
    sd: dict = {"embedding.0.weights": _t(params["fourier_w"])}
    _dense(sd, "embedding.1", params["proj"])
    return sd


def sao_dit_from_jax(params: dict) -> dict:
    """StableAudioDiT flax params -> port state_dict (stable_audio_tools'
    names, the inverse of ``sao_dit_mapping``; the gamma-only norms' zero
    ``beta`` buffers included)."""
    sd: dict = {"timestep_features.weight": _t(params["timestep_w"])}
    for ours, theirs in (("t1", "to_timestep_embed.0"), ("t2", "to_timestep_embed.2"),
                         ("c1", "to_cond_embed.0"), ("c2", "to_cond_embed.2"),
                         ("g1", "to_global_embed.0"), ("g2", "to_global_embed.2"),
                         ("project_in", "transformer.project_in"),
                         ("project_out", "transformer.project_out")):
        _dense(sd, theirs, params[ours])
    for name in ("preprocess_conv", "postprocess_conv"):
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T[:, :, None])
    for i in range(_count(params, "layer_")):
        p, b = params[f"layer_{i}"], f"transformer.layers.{i}"
        for norm in ("pre_norm", "cross_attend_norm", "ff_norm"):
            gamma = np.asarray(p[norm]["ln"]["scale"])
            sd[f"{b}.{norm}.gamma"] = _t(gamma)
            sd[f"{b}.{norm}.beta"] = torch.zeros(gamma.shape)
        _dense(sd, f"{b}.self_attn.to_qkv", p["self_attn"]["to_qkv"])
        _dense(sd, f"{b}.self_attn.to_out", p["self_attn"]["to_out"])
        for n in ("to_q", "to_kv", "to_out"):
            _dense(sd, f"{b}.cross_attn.{n}", p["cross_attn"][n])
        _dense(sd, f"{b}.ff.ff.0.proj", p["ff"]["proj"])
        _dense(sd, f"{b}.ff.ff.2", p["ff"]["out"])
    return sd


def sao_oobleck_from_jax(params: dict) -> dict:
    """The checkpoint OobleckDecoder's flax params -> port state_dict
    (stable_audio_tools' ``layers.N`` names, the inverse of
    ``oobleck_mapping``)."""
    sd: dict = {}

    def snake(key, node):
        sd[f"{key}.alpha"] = _t(node["alpha"])
        sd[f"{key}.beta"] = _t(node["beta"])

    _conv1d(sd, "layers.0", params["conv_in"])
    n = _count(params, "up_snake_")
    for bi in range(n):
        blk = f"layers.{1 + bi}.layers"
        snake(f"{blk}.0", params[f"up_snake_{bi}"])
        _conv_t1d(sd, f"{blk}.1", params[f"up_{bi}"])
        for j in range(3):
            res, node = f"{blk}.{2 + j}.layers", params[f"res_{bi}_{j}"]
            snake(f"{res}.0", node["s1"])
            _conv1d(sd, f"{res}.1", node["c1"])
            snake(f"{res}.2", node["s2"])
            _conv1d(sd, f"{res}.3", node["c2"])
    snake(f"layers.{1 + n}", params["snake_out"])
    _conv1d(sd, f"layers.{2 + n}", params["conv_out"])
    return sd


def vocos_from_jax(params: dict) -> dict:
    """Vocos flax params -> port state_dict (charactr/vocos' names, the
    inverse of ``vocos_mapping``)."""
    sd: dict = {}
    _conv1d(sd, "backbone.embed", params["embed"])
    _norm(sd, "backbone.norm", params["norm_in"])
    for i in range(_count(params, "block_")):
        p, b = params[f"block_{i}"], f"backbone.convnext.{i}"
        _conv1d(sd, f"{b}.dwconv", p["dwconv"])
        _norm(sd, f"{b}.norm", p["norm"])
        _dense(sd, f"{b}.pwconv1", p["pw1"])
        _dense(sd, f"{b}.pwconv2", p["pw2"])
        sd[f"{b}.gamma"] = _t(p["gamma"])
    _norm(sd, "backbone.final_layer_norm", params["norm_out"])
    _dense(sd, "head.out", params["head"])
    return sd


# ------------------------------------------------ music: checkpoint ACE-Step, CLAP, LoRA

def acestep_dit_from_jax(params: dict) -> dict:
    """The checkpoint-layout ACEStepDiT's flax params -> port state_dict
    (the published transformer's names, the inverse of
    ``acestep_dit_mapping``): ``proj_in``'s Dense over flattened
    (channel, height) patches becomes the (16, 1) Conv2d."""
    sd: dict = {"lyric_embs.weight": _t(params["lyric_embs"]["embedding"])}
    for ours, theirs in (("speaker_embedder", "speaker_embedder"),
                         ("genre_embedder", "genre_embedder"), ("lyric_proj", "lyric_proj"),
                         ("timestep_embedder_linear_1", "timestep_embedder.linear_1"),
                         ("timestep_embedder_linear_2", "timestep_embedder.linear_2"),
                         ("t_block", "t_block.1")):
        _dense(sd, theirs, params[ours])
    pin = params["proj_in"]
    k0 = np.asarray(pin["early0"]["kernel"])               # (c * kh, mid)
    kh = k0.shape[0] // (k0.shape[1] // 256)
    sd["proj_in.early_conv_layers.0.weight"] = _t(k0.T.reshape(k0.shape[1], -1, kh, 1))
    sd["proj_in.early_conv_layers.0.bias"] = _t(pin["early0"]["bias"])
    _norm(sd, "proj_in.early_conv_layers.1", pin["gn"])
    sd["proj_in.early_conv_layers.2.weight"] = _t(np.asarray(pin["early2"]["kernel"]).T[:, :, None, None])
    sd["proj_in.early_conv_layers.2.bias"] = _t(pin["early2"]["bias"])
    for i in range(_count(params, "block_")):
        p, b = params[f"block_{i}"], f"transformer_blocks.{i}"
        sd[f"{b}.scale_shift_table"] = _t(p["scale_shift_table"])
        for a in ("attn", "cross_attn"):
            for proj in ("to_q", "to_k", "to_v"):
                _dense(sd, f"{b}.{a}.{proj}", p[a][proj])
            _dense(sd, f"{b}.{a}.to_out.0", p[a]["to_out"])
        for conv in ("inverted_conv", "depth_conv", "point_conv"):
            _conv1d(sd, f"{b}.ff.{conv}.conv", p["ff"][conv])
    sd["final_layer.scale_shift_table"] = _t(params["final_layer"]["scale_shift_table"])
    _dense(sd, "final_layer.linear", params["final_layer"]["linear"])
    i = 0
    while f"projector_{i}_0" in params:
        for j in range(3):
            _dense(sd, f"projectors.{i}.{2 * j}", params[f"projector_{i}_{j}"])
        i += 1
    return sd


def acestep_lyric_from_jax(params: dict) -> dict:
    """LyricConformerEncoder flax params -> port state_dict (the checkpoint's
    ``lyric_encoder`` names, the inverse of ``acestep_lyric_mapping``)."""
    sd: dict = {}
    _dense(sd, "embed.out.0", params["embed_lin"])
    _norm(sd, "embed.out.1", params["embed_norm"])
    for i in range(_count(params, "attn_")):
        a, b = params[f"attn_{i}"], f"encoders.{i}"
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _dense(sd, f"{b}.self_attn.{lin}", a[lin])
        sd[f"{b}.self_attn.pos_bias_u"] = _t(a["pos_bias_u"])
        sd[f"{b}.self_attn.pos_bias_v"] = _t(a["pos_bias_v"])
        _norm(sd, f"{b}.norm_mha", params[f"norm_mha_{i}"])
        _norm(sd, f"{b}.norm_ff", params[f"norm_ff_{i}"])
        _dense(sd, f"{b}.feed_forward.w_1", params[f"ff_w1_{i}"])
        _dense(sd, f"{b}.feed_forward.w_2", params[f"ff_w2_{i}"])
    _norm(sd, "after_norm", params["after_norm"])
    return sd


def _dcae_walk(sd: dict, key: str, node: dict) -> None:
    """A DCAE subtree under diffusers' names: ``down_i_j``/``up_i_j`` ->
    ``down_blocks.i.j``/``up_blocks.i.j``, ``to_qkv_multiscale_s`` ->
    ``to_qkv_multiscale.s``; 4-D kernels are Conv2d, 2-D ones Linear, the
    RMSNorms' weight and bias leaves as they are."""
    if "kernel" in node:
        (_conv2d if np.ndim(node["kernel"]) == 4 else _dense)(sd, key, node)
        return
    for name, child in node.items():
        m = re.fullmatch(r"(down|up)_(\d+)_(\d+)", name)
        if m:
            name = f"{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}"
        name = re.sub(r"^to_qkv_multiscale_(\d+)$", r"to_qkv_multiscale.\1", name)
        sub = f"{key}.{name}" if key else name
        if isinstance(child, dict):
            _dcae_walk(sd, sub, child)
        else:
            sd[sub] = _t(child)


def dcae_from_jax(params: dict) -> dict:
    """AutoencoderDC flax params -> port state_dict (diffusers' names, the
    inverse of ``dcae_mapping``)."""
    sd: dict = {}
    _dcae_walk(sd, "", params)
    return sd


def adamos_from_jax(params: dict) -> dict:
    """AdamosVocoder flax params -> port state_dict (music_vocoder.py's
    names, the inverse of ``adamos_mapping``; weight-normed convolutions
    as their folded ``weight``)."""
    sd: dict = {}
    bk, hd = params["backbone"], params["head"]
    _conv1d(sd, "backbone.channel_layers.0.0", bk["stem_conv"])
    _norm(sd, "backbone.channel_layers.0.1", bk["stem_norm"])
    for i in range(1, 1 + _count(bk, "mid_norm_")):
        _norm(sd, f"backbone.channel_layers.{i}.0", bk[f"mid_norm_{i}"])
        _dense_as_conv1x1(sd, f"backbone.channel_layers.{i}.1", bk[f"mid_proj_{i}"])
    for name, node in bk.items():
        m = re.fullmatch(r"stage_(\d+)_(\d+)", name)
        if not m:
            continue
        b = f"backbone.stages.{m.group(1)}.{m.group(2)}"
        _conv1d(sd, f"{b}.dwconv", node["dwconv"])
        _norm(sd, f"{b}.norm", node["norm"])
        _dense(sd, f"{b}.pwconv1", node["pwconv1"])
        _dense(sd, f"{b}.pwconv2", node["pwconv2"])
        sd[f"{b}.gamma"] = _t(node["gamma"])
    _norm(sd, "backbone.norm", bk["final_norm"])
    _conv1d(sd, "head.conv_pre", hd["conv_pre"])
    n_kernels = _count(hd, "res_0_")
    for i in range(_count(hd, "up_")):
        _conv_t1d(sd, f"head.ups.{i}", hd[f"up_{i}"])
        for j in range(n_kernels):
            res, key = hd[f"res_{i}_{j}"], f"head.resblocks.{i * n_kernels + j}"
            for d in range(_count(res, "c1_")):
                _conv1d(sd, f"{key}.convs1.{d}", res[f"c1_{d}"])
                _conv1d(sd, f"{key}.convs2.{d}", res[f"c2_{d}"])
    _conv1d(sd, "head.conv_post", hd["conv_post"])
    return sd


def clap_text_from_jax(params: dict) -> dict:
    """ClapTextBranch flax params -> port state_dict (laion_clap's names, the
    inverse of ``clap_text_mapping``)."""
    e = "text_branch.embeddings"
    sd: dict = {f"{e}.word_embeddings.weight": _t(params["word_emb"]["embedding"]),
                f"{e}.position_embeddings.weight": _t(params["pos_emb"]["embedding"]),
                f"{e}.token_type_embeddings.weight": _t(params["type_emb"]["embedding"])}
    _norm(sd, f"{e}.LayerNorm", params["emb_ln"])
    for i in range(_count(params, "layer_")):
        p, b = params[f"layer_{i}"], f"text_branch.encoder.layer.{i}"
        for ours, theirs in (("q", "attention.self.query"), ("k", "attention.self.key"),
                             ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                             ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            _dense(sd, f"{b}.{theirs}", p[ours])
        _norm(sd, f"{b}.attention.output.LayerNorm", p["attn_ln"])
        _norm(sd, f"{b}.output.LayerNorm", p["ffn_ln"])
    _dense(sd, "text_branch.pooler.dense", params["pooler"])
    _dense(sd, "text_projection.0", params["proj0"])
    _dense(sd, "text_projection.2", params["proj1"])
    return sd


def clap_audio_from_jax(params: dict) -> dict:
    """ClapAudioBranch flax params -> port state_dict (laion_clap's HTSAT
    names, the inverse of ``clap_audio_mapping``)."""
    sd: dict = {}
    _conv2d(sd, "audio_branch.patch_embed.proj", params["patch_proj"])
    _norm(sd, "audio_branch.patch_embed.norm", params["patch_norm"])
    li = 0
    while f"l{li}_b0" in params:
        bi = 0
        while f"l{li}_b{bi}" in params:
            p, b = params[f"l{li}_b{bi}"], f"audio_branch.layers.{li}.blocks.{bi}"
            _norm(sd, f"{b}.norm1", p["norm1"])
            _dense(sd, f"{b}.attn.qkv", p["qkv"])
            sd[f"{b}.attn.relative_position_bias_table"] = _t(p["rel_bias"])
            _dense(sd, f"{b}.attn.proj", p["proj"])
            _norm(sd, f"{b}.norm2", p["norm2"])
            _dense(sd, f"{b}.mlp.fc1", p["fc1"])
            _dense(sd, f"{b}.mlp.fc2", p["fc2"])
            bi += 1
        if f"merge_{li}_norm" in params:
            _norm(sd, f"audio_branch.layers.{li}.downsample.norm", params[f"merge_{li}_norm"])
            _dense(sd, f"audio_branch.layers.{li}.downsample.reduction", params[f"merge_{li}_red"])
        li += 1
    _norm(sd, "audio_branch.norm", params["norm"])
    _dense(sd, "audio_projection.0", params["proj0"])
    _dense(sd, "audio_projection.2", params["proj1"])
    return sd


def lora_from_jax(lora: dict) -> dict:
    """The JAX ``lora_init``/``train_lora`` factors ``{path: {"a", "b"}}`` ->
    the port's (the same paths, relative to the DiT: the port's DiT keeps
    the flax module names; fp32 CPU tensors)."""
    return {tuple(p): {n: _t(ab[n]) for n in ("a", "b")} for p, ab in lora.items()}


# ------------------------------------------------------------ YuE and its codecs

def soundstream_from_jax(params: dict) -> dict:
    """SoundStreamCodec flax params -> port state_dict (the flax names:
    SEANet has no upstream checkpoint; the decoder's ``up_N`` are transposed
    convolutions, ``rvq.codebooks`` is taken as it is)."""
    sd: dict = {}
    _flax_walk(sd, "", params, conv_t=("up_",))
    return sd


def xcodec_from_jax(params: dict) -> dict:
    """XCodecDecoder flax params -> port state_dict under the xcodec
    checkpoint's names (the inverse of ``xcodec_mapping`` on folded
    weights): the codebooks as ``quantizer.vq.layers.N._codebook.embed``,
    ``fc_post2``, and ``decoder_2.model.N`` with each upsampler's kernel
    (the dilate-pad-conv kernel of ``TorchConvTranspose``, spatially
    flipped) back in torch's (in, out, k)."""
    sd: dict = {}
    for i in range(_count(params, "codebook_")):
        sd[f"quantizer.vq.layers.{i}._codebook.embed"] = _t(params[f"codebook_{i}"]["embedding"])
    _dense(sd, "fc_post2", params["fc_post2"])

    def snake(key: str, node: dict) -> None:
        sd[f"{key}.alpha"] = _t(np.asarray(node["alpha"]).reshape(1, -1, 1))

    _conv1d(sd, "decoder_2.model.0", params["conv_in"])
    n_rates = _count(params, "up_")
    for i in range(n_rates):
        blk = f"decoder_2.model.{1 + i}.block"
        snake(f"{blk}.0", params[f"snake_{i}"])
        _conv_t1d(sd, f"{blk}.1", params[f"up_{i}"]["conv"])
        for j in range(3):
            res, node = f"{blk}.{2 + j}.block", params[f"res_{i}_{j}"]
            snake(f"{res}.0", node["s1"])
            _conv1d(sd, f"{res}.1", node["c1"])
            snake(f"{res}.2", node["s2"])
            _conv1d(sd, f"{res}.3", node["c2"])
    snake(f"decoder_2.model.{1 + n_rates}", params["snake_out"])
    _conv1d(sd, f"decoder_2.model.{2 + n_rates}", params["conv_out"])
    return sd


def yue_from_jax(s1_params: dict, s2_params: dict, codec_params: dict | None = None,
                 vocos_params: dict | None = None,
                 xcodec_params: dict | None = None) -> dict[str, dict | None]:
    """A JAX YuEPipeline's trees -> the port modules' state_dicts: "s1" and
    "s2" (``lm_from_jax``, HF LLaMA's names), "codec", "vocos" and "xcodec"
    (None where the tree is)."""
    return {"s1": lm_from_jax(s1_params), "s2": lm_from_jax(s2_params),
            "codec": None if codec_params is None else soundstream_from_jax(codec_params),
            "vocos": None if vocos_params is None else vocos_from_jax(vocos_params),
            "xcodec": None if xcodec_params is None else xcodec_from_jax(xcodec_params)}
