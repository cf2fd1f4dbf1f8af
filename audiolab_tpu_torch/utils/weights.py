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
            kern = np.asarray(tpl["convt"]["kernel"])[::-1, ::-1]
            sd[f"{key}.conv1.0.weight"] = _t(np.transpose(kern, (2, 3, 0, 1)))
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

def synthesizer_from_jax(params: dict) -> dict:
    """SynthesizerTrn flax params (inference tree) -> port state_dict
    (upstream SynthesizerTrnMs768NSFsid names)."""
    sd: dict = {}
    ep = params["enc_p"]
    _dense(sd, "enc_p.emb_phone", ep["emb_phone"])
    if "emb_pitch" in ep:
        sd["enc_p.emb_pitch.weight"] = _t(ep["emb_pitch"]["embedding"])
    _conv1d(sd, "enc_p.proj", ep["proj"]["Conv_0"])
    enc, b = ep["encoder"], "enc_p.encoder"
    for i in range(_count(enc, "attn_")):
        a = enc[f"attn_{i}"]
        for w in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _dense_as_conv1x1(sd, f"{b}.attn_layers.{i}.{w}", a[w])
        sd[f"{b}.attn_layers.{i}.emb_rel_k"] = _t(a["emb_rel_k"])
        sd[f"{b}.attn_layers.{i}.emb_rel_v"] = _t(a["emb_rel_v"])
        _norm(sd, f"{b}.norm_layers_1.{i}", enc[f"norm1_{i}"], ("gamma", "beta"))
        _norm(sd, f"{b}.norm_layers_2.{i}", enc[f"norm2_{i}"], ("gamma", "beta"))
        _conv1d(sd, f"{b}.ffn_layers.{i}.conv_1", enc[f"ffn_{i}"]["conv_1"]["Conv_0"])
        _conv1d(sd, f"{b}.ffn_layers.{i}.conv_2", enc[f"ffn_{i}"]["conv_2"]["Conv_0"])
    flow = params["flow"]
    for fi in range(_count(flow, "flow_")):
        f, t = flow[f"flow_{fi}"], f"flow.flows.{2 * fi}"
        _conv1d(sd, f"{t}.pre", f["pre"]["Conv_0"])
        _conv1d(sd, f"{t}.post", f["post"]["Conv_0"])
        for j in range(_count(f["enc"], "in_layer_")):
            _conv1d(sd, f"{t}.enc.in_layers.{j}", f["enc"][f"in_layer_{j}"]["Conv_0"])
            _conv1d(sd, f"{t}.enc.res_skip_layers.{j}", f["enc"][f"res_skip_{j}"]["Conv_0"])
        if "cond_layer" in f["enc"]:
            _conv1d(sd, f"{t}.enc.cond_layer", f["enc"]["cond_layer"]["Conv_0"])
    dec = params["dec"]
    _conv1d(sd, "dec.conv_pre", dec["conv_pre"]["Conv_0"])
    if "cond" in dec:
        _conv1d(sd, "dec.cond", dec["cond"]["Conv_0"])
    _conv1d(sd, "dec.conv_post", dec["conv_post"]["Conv_0"])
    _dense(sd, "dec.m_source.l_linear", dec["source_linear"])
    n_kernels = sum(1 for k in dec if k.startswith("resblock_0_"))
    for key, node in dec.items():
        if key.startswith("up_"):
            i = int(key.split("_")[1])
            kern = np.asarray(node["ConvTranspose_0"]["kernel"])[::-1]
            sd[f"dec.ups.{i}.weight"] = _t(np.transpose(kern, (1, 2, 0)))
            sd[f"dec.ups.{i}.bias"] = _t(node["ConvTranspose_0"]["bias"])
        elif key.startswith("noise_conv_"):
            _conv1d(sd, f"dec.noise_convs.{int(key.split('_')[2])}", node)
        elif key.startswith("resblock_"):
            _, i, j = key.split("_")
            flat = int(i) * n_kernels + int(j)
            for cj in range(_count(node, "conv1_")):
                _conv1d(sd, f"dec.resblocks.{flat}.convs1.{cj}", node[f"conv1_{cj}"]["Conv_0"])
                _conv1d(sd, f"dec.resblocks.{flat}.convs2.{cj}", node[f"conv2_{cj}"]["Conv_0"])
    sd["emb_g.weight"] = _t(params["emb_g"]["embedding"])
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
