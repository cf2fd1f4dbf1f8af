"""The port's ONNX reader, writer and runner (utils/onnx.py) and MDX models
(models/separation/mdx.py) against the JAX package's, on the CPU, in fp32:
the graphs of tests/test_onnx_exec.py, a graph with every other op the
runner accepts, MDXOnnxSeparator's framing and MDXNet.  Weights and inputs
come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models.separation import mdx as JMdx
from audiolab_tpu.utils import onnx as JOnnx
from audiolab_tpu_torch.models.separation import mdx as TMdx
from audiolab_tpu_torch.utils import onnx as TOnnx
from audiolab_tpu_torch.utils.weights import mdxnet_from_jax


def _r(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _conv_bn_relu(rng):
    nodes = [("Conv", ["x", "w", "b"], ["c"],
              {"strides": [2, 2], "pads": [1, 1, 1, 1], "kernel_shape": [3, 3]}),
             ("BatchNormalization", ["c", "g", "be", "m", "v"], ["n"], {"epsilon": 1e-5}),
             ("Relu", ["n"], ["y"], {})]
    inits = {"w": _r(rng, 8, 3, 3, 3), "b": _r(rng, 8), "g": _r(rng, 8), "be": _r(rng, 8),
             "m": _r(rng, 8), "v": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    return nodes, inits, {"x": _r(rng, 1, 3, 12, 10)}


def _conv_transpose(rng):
    nodes = [("ConvTranspose", ["x", "w", "b"], ["y"], {"strides": [2, 2], "pads": [1, 1, 1, 1]})]
    return nodes, {"w": _r(rng, 6, 4, 4, 4), "b": _r(rng, 4)}, {"x": _r(rng, 2, 6, 7, 9)}


def _mini_tfc_tdf_unet(rng):
    """test_onnx_exec.py's miniature MDX-style net: conv stem, TDF matmuls
    over the last axis, skip concat, transposed-conv upsample."""
    nodes = [
        ("Conv", ["x", "w0", "b0"], ["s"], {}), ("Relu", ["s"], ["h"], {}),
        ("Conv", ["h", "w1", "b1"], ["t0"], {"pads": [1, 1, 1, 1]}), ("Relu", ["t0"], ["t"], {}),
        ("MatMul", ["t", "w2t"], ["d0"], {}), ("Add", ["d0", "b2"], ["d1"], {}),
        ("Relu", ["d1"], ["d2"], {}),
        ("MatMul", ["d2", "w3t"], ["d3"], {}), ("Add", ["d3", "b3"], ["d4"], {}),
        ("Add", ["h", "d4"], ["hs"], {}),
        ("Conv", ["hs", "w4", "b4"], ["dn0"], {"strides": [2, 2]}), ("Relu", ["dn0"], ["dn"], {}),
        ("ConvTranspose", ["dn", "w5", "b5"], ["u"], {"strides": [2, 2]}),
        ("Concat", ["hs", "u"], ["cat"], {"axis": 1}),
        ("Conv", ["cat", "w6", "b6"], ["y"], {}),
    ]
    inits = {"w0": _r(rng, 8, 4, 1, 1), "b0": _r(rng, 8), "w1": _r(rng, 8, 8, 3, 3, scale=0.3),
             "b1": _r(rng, 8), "w2t": _r(rng, 16, 4, scale=0.3), "b2": _r(rng, 4),
             "w3t": _r(rng, 4, 16, scale=0.3), "b3": _r(rng, 16),
             "w4": _r(rng, 16, 8, 2, 2, scale=0.3), "b4": _r(rng, 16),
             "w5": _r(rng, 16, 8, 2, 2, scale=0.3), "b5": _r(rng, 8),
             "w6": _r(rng, 4, 16, 1, 1, scale=0.3), "b6": _r(rng, 4)}
    return nodes, inits, {"x": _r(rng, 1, 4, 8, 16)}


def _static_folding(rng):
    """Shape -> Gather folded on the host; pooling, Sigmoid, Slice, Pad."""
    nodes = [("Shape", ["x"], ["shp"], {}),
             ("Gather", ["shp", "i0"], ["b_dim"], {"axis": 0}),
             ("AveragePool", ["x"], ["p"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
             ("Sigmoid", ["p"], ["sg"], {}),
             ("Slice", ["sg", "st", "en", "ax"], ["sl"], {}),
             ("Pad", ["sl", "pads"], ["y"], {"mode": "constant"})]
    inits = {"i0": np.asarray(0, np.int64), "st": np.asarray([0], np.int64),
             "en": np.asarray([3], np.int64), "ax": np.asarray([1], np.int64),
             "pads": np.asarray([0, 0, 1, 0, 0, 0, 1, 0], np.int64)}
    return nodes, inits, {"x": _r(rng, 2, 6, 8, 8)}


def _every_other_op(rng):
    """The ops the graphs above leave out: asymmetric and grouped Conv, a 1-d
    ConvTranspose with output padding and uneven pads, Gemm, the norms, the
    activations, reshapes folded from Shape, reflect / edge Pad, MaxPool,
    GlobalAveragePool, Softmax, Cast, Clip, Identity, Constant, Div, Sub."""
    nodes = [
        ("Conv", ["x", "wg"], ["c0"], {"pads": [0, 1, 2, 1], "group": 2, "dilations": [1, 2]}),
        ("InstanceNormalization", ["c0", "ig", "ib"], ["c1"], {"epsilon": 1e-5}),
        ("LeakyRelu", ["c1"], ["c2"], {"alpha": 0.1}),
        ("MaxPool", ["c2"], ["c3"], {"kernel_shape": [2, 2], "strides": [2, 1],
                                     "pads": [0, 0, 1, 1]}),
        ("Pad", ["c3", "rp"], ["c4"], {"mode": "reflect"}),
        ("Pad", ["c4", "ep"], ["c5"], {"mode": "edge"}),
        ("Elu", ["c5"], ["c6"], {"alpha": 0.5}),
        ("Shape", ["c6"], ["s0"], {}),
        ("Gather", ["s0", "i3"], ["s1"], {"axis": 0}),
        ("Mul", ["s1", "s1"], ["s2"], {}),
        ("Concat", ["m1", "s2"], ["s3"], {"axis": 0}),
        ("Reshape", ["c6", "s3"], ["r0"], {}),
        ("Gemm", ["r0", "gw", "gb"], ["g0"], {"transB": 1, "alpha": 0.5, "beta": 2.0}),
        ("Tanh", ["g0"], ["g1"], {}),
        ("Unsqueeze", ["g1", "ax1"], ["u0"], {}),
        ("Transpose", ["u0"], ["u1"], {"perm": [1, 0, 2]}),
        ("ConvTranspose", ["u1", "wt"], ["u2"], {"strides": [3], "pads": [1, 2],
                                                 "output_padding": [1]}),
        ("BatchNormalization", ["u2", "bg", "bb", "bm", "bv"], ["u3"], {"epsilon": 1e-3}),
        ("GlobalAveragePool", ["u3"], ["u4"], {}),
        ("Squeeze", ["u4", "ax2"], ["u5"], {}),
        ("Softmax", ["u5"], ["u6"], {"axis": 1}),
        ("Constant", [], ["k0"], {"value": np.asarray([3.0], np.float32)}),
        ("Div", ["u6", "k0"], ["u7"], {}),
        ("Sub", ["u7", "k0"], ["u8"], {}),
        ("Clip", ["u8", "lo", "hi"], ["u9"], {}),
        ("Cast", ["u9"], ["u10"], {"to": 1}),
        ("Identity", ["u10"], ["y"], {}),
    ]
    inits = {"wg": _r(rng, 6, 2, 3, 3, scale=0.3), "ig": _r(rng, 6), "ib": _r(rng, 6),
             "rp": np.asarray([0, 0, 1, 2, 0, 0, 2, 1], np.int64),
             "ep": np.asarray([0, 0, 0, 1, 0, 0, 1, 0], np.int64),
             "i3": np.asarray([3], np.int64), "m1": np.asarray([-1], np.int64),
             "gw": _r(rng, 5, 64, scale=0.1), "gb": _r(rng, 5),
             "ax1": np.asarray([1], np.int64), "ax2": np.asarray([2], np.int64),
             "wt": _r(rng, 12, 3, 4, scale=0.3), "bg": _r(rng, 3), "bb": _r(rng, 3),
             "bm": _r(rng, 3),
             "bv": rng.uniform(0.5, 2.0, 3).astype(np.float32),
             "lo": np.asarray(-2.975, np.float32), "hi": np.asarray(-2.8, np.float32)}
    return nodes, inits, {"x": _r(rng, 2, 4, 7, 6)}


GRAPHS = {"conv_bn_relu": _conv_bn_relu, "conv_transpose": _conv_transpose,
          "mini_tfc_tdf_unet": _mini_tfc_tdf_unet, "static_folding": _static_folding,
          "every_other_op": _every_other_op}


def _models(name):
    nodes, inits, feeds = GRAPHS[name](np.random.default_rng(len(name)))
    j = JOnnx.build_model([JOnnx.OnnxNode(*n) for n in nodes], inits, list(feeds), ["y"])
    t = TOnnx.build_model([TOnnx.OnnxNode(*n) for n in nodes], inits, list(feeds), ["y"])
    return j, t, feeds


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_writer_and_parser_match_jax(name):
    """The same bytes from both writers; the same graph from both parsers."""
    jbytes, tbytes, _ = _models(name)
    assert tbytes == jbytes
    jg, tg = JOnnx.parse_model(jbytes), TOnnx.parse_model(tbytes)
    assert (tg.inputs, tg.outputs) == (jg.inputs, jg.outputs)
    assert [(n.op_type, n.inputs, n.outputs) for n in tg.nodes] == [
        (n.op_type, n.inputs, n.outputs) for n in jg.nodes]
    for tn, jn in zip(tg.nodes, jg.nodes):
        assert tn.attrs.keys() == jn.attrs.keys()
        for k in tn.attrs:
            np.testing.assert_array_equal(np.asarray(tn.attrs[k]), np.asarray(jn.attrs[k]))
    assert tg.initializers.keys() == jg.initializers.keys()
    for k, v in tg.initializers.items():
        assert v.dtype == jg.initializers[k].dtype
        np.testing.assert_array_equal(v, jg.initializers[k])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_runner_matches_jax(name):
    """OnnxRunner against the JAX runner on the same graph and feeds: 1e-5
    of max|y| in fp32 (sums in another order), shapes equal."""
    jbytes, tbytes, feeds = _models(name)
    (ref,) = JOnnx.OnnxRunner(JOnnx.parse_model(jbytes))(
        **{k: jnp.asarray(v) for k, v in feeds.items()})
    ref = np.asarray(ref)
    (out,) = TOnnx.OnnxRunner(TOnnx.parse_model(tbytes))(
        **{k: torch.from_numpy(v) for k, v in feeds.items()})
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_runner_rejects_unknown_ops():
    data = TOnnx.build_model([TOnnx.OnnxNode("Erf", ["x"], ["y"], {})], {}, ["x"], ["y"])
    with pytest.raises(NotImplementedError, match="Erf"):
        TOnnx.OnnxRunner(TOnnx.parse_model(data))(x=torch.zeros(2))


def test_mdx_onnx_separator_identity_reconstructs():
    """An Identity graph with dim_f = every bin: the framing (channel packing,
    trim-margin windows, iSTFT) gives the mix back away from the outermost
    trim, across window seams, and target + complement = mix."""
    n_fft, hop, dim_t = 128, 32, 16
    data = TOnnx.build_model([TOnnx.OnnxNode("Identity", ["input"], ["output"], {})],
                             {}, ["input"], ["output"])
    sep = TMdx.MDXOnnxSeparator(TOnnx.parse_model(data), dim_f=n_fft // 2 + 1, dim_t=dim_t,
                                n_fft=n_fft, hop=hop)
    n = sep.chunk * 2 + 100
    audio = torch.from_numpy(_r(np.random.default_rng(0), 1, 2, n, scale=0.3))
    out = sep(audio)
    assert set(out) == {"vocals", "instrumental"} and out["vocals"].shape == (1, 2, n)
    trim = n_fft // 2
    np.testing.assert_allclose(out["vocals"][..., trim:-trim].numpy(),
                               audio[..., trim:-trim].numpy(), atol=1e-5)
    np.testing.assert_allclose((out["vocals"] + out["instrumental"]).numpy(), audio.numpy(),
                               atol=1e-6)


def test_mdx_onnx_separator_matches_jax():
    """A conv-mask graph through both separators on three windows: 1e-5 of
    the input's peak."""
    rng = np.random.default_rng(5)
    nodes = [("Conv", ["input", "w", "b"], ["s"], {"pads": [1, 1, 1, 1]}),
             ("Sigmoid", ["s"], ["m"], {}), ("Mul", ["m", "input"], ["output"], {})]
    inits = {"w": _r(rng, 4, 4, 3, 3, scale=0.3), "b": _r(rng, 4)}
    kw = dict(dim_f=32, dim_t=16, n_fft=128, hop=32)
    jsep = JMdx.MDXOnnxSeparator(JOnnx.parse_model(JOnnx.build_model(
        [JOnnx.OnnxNode(*n) for n in nodes], inits, ["input"], ["output"])), **kw)
    tsep = TMdx.MDXOnnxSeparator(TOnnx.parse_model(TOnnx.build_model(
        [TOnnx.OnnxNode(*n) for n in nodes], inits, ["input"], ["output"])), **kw)
    audio = _r(rng, 2, 2, 2 * tsep.chunk + 50, scale=0.2)
    ref = jsep(jnp.asarray(audio))
    out = tsep(torch.from_numpy(audio))
    assert set(out) == set(ref)
    for stem in ref:
        np.testing.assert_allclose(out[stem].numpy(), np.asarray(ref[stem]),
                                   atol=1e-5 * np.abs(audio).max(), rtol=0)


def test_mdxnet_matches_jax():
    """MDXNet on seeded parameters over a jax.eval_shape template: both stems
    to 1e-5 of max|y|; an odd frame count takes flax's SAME padding of the
    strided convs."""
    cfg = dict(n_fft=256, hop=64, dim_f=64, g=8, depth=2, tfc_layers=2, bn=4)
    jm = JMdx.MDXNet(JMdx.MDXConfig(**cfg))
    n = 64 * 20                                     # 21 frames
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, n))))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(lambda s: _r(rng, *s.shape, scale=0.2), tpl)
    tm = TMdx.MDXNet(TMdx.MDXConfig(**cfg))
    tm.load_state_dict(mdxnet_from_jax(params), strict=True)
    x = _r(rng, 2, 2, n, scale=0.3)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert set(out) == set(ref) == {"vocals", "other"}
    for stem in ref:
        r = np.asarray(ref[stem])
        np.testing.assert_allclose(out[stem].numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0)
