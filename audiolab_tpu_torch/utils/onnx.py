"""ONNX import and execution on torch (counterpart of
audiolab_tpu/utils/onnx.py; no onnxruntime, no onnx package).

The reference runs its MDX-NET separation members through onnxruntime.
Here the protobuf wire format is parsed directly (field numbers from the
public onnx.proto spec; the parser and the writer ``build_model`` are
framework-free host code, the JAX package's own) and the graph runs as
torch ops in NCHW on the input's device.

Scope: the static-shape conv/matmul op set of audio U-Nets.  Shape-only
subgraphs (Shape -> Gather -> Concat -> Reshape chains that exporters emit)
are folded with numpy on the host, so only tensor math reaches the device.
Conv, ConvTranspose, MatMul and Gemm run under the precision policy
(core/precision.py), as the JAX runner's products do under
``jax.default_matmul_precision``.  Unknown ops raise.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.core import precision

# ------------------------------------------------------------- wire format

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


# onnx TensorProto.DataType
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = 1
    raw = None
    floats: list[float] = []
    i32: list[int] = []
    i64: list[int] = []
    name = ""
    for fno, wt, v in _fields(buf):
        if fno == 1:
            dims.append(v)
        elif fno == 2:
            dtype = v
        elif fno == 4:
            if wt == 2:  # packed
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif fno == 5:
            if wt == 2:
                j = 0
                while j < len(v):
                    x, j = _read_varint(v, j)
                    i32.append(x)
            else:
                i32.append(v)
        elif fno == 7:
            if wt == 2:
                j = 0
                while j < len(v):
                    x, j = _read_varint(v, j)
                    i64.append(x)
            else:
                i64.append(v)
        elif fno == 8:
            name = v.decode("utf-8")
        elif fno == 9:
            raw = v
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    elif i64:
        arr = np.asarray(i64, np_dtype)
    elif i32:
        arr = np.asarray(i32, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(buf: bytes) -> tuple[str, object]:
    name = ""
    out: object = None
    ints: list[int] = []
    floats: list[float] = []
    strings: list[bytes] = []
    for fno, wt, v in _fields(buf):
        if fno == 1:
            name = v.decode("utf-8")
        elif fno == 2:
            out = struct.unpack("<f", v)[0]
        elif fno == 3:
            out = v - (1 << 64) if v >= (1 << 63) else v
        elif fno == 4:
            out = v.decode("utf-8")
        elif fno == 5:
            out = _parse_tensor(v)[1]
        elif fno == 7:
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif fno == 8:
            if wt == 2:
                j = 0
                while j < len(v):
                    x, j = _read_varint(v, j)
                    ints.append(x - (1 << 64) if x >= (1 << 63) else x)
            else:
                ints.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif fno == 9:
            strings.append(v)
    if ints:
        out = ints
    elif floats and out is None:
        out = floats
    elif strings:
        out = [s.decode("utf-8") for s in strings]
    return name, out


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict


@dataclass
class OnnxGraph:
    nodes: list[OnnxNode] = field(default_factory=list)
    initializers: dict = field(default_factory=dict)
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [], {})
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            node.inputs.append(v.decode("utf-8"))
        elif fno == 2:
            node.outputs.append(v.decode("utf-8"))
        elif fno == 4:
            node.op_type = v.decode("utf-8")
        elif fno == 5:
            k, a = _parse_attr(v)
            node.attrs[k] = a
    return node


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            g.nodes.append(_parse_node(v))
        elif fno == 5:
            name, arr = _parse_tensor(v)
            g.initializers[name] = arr
        elif fno == 11:
            g.inputs.append(_vi_name(v))
        elif fno == 12:
            g.outputs.append(_vi_name(v))
    return g


def _vi_name(buf: bytes) -> str:
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            return v.decode("utf-8")
    return ""


def parse_model(data: bytes) -> OnnxGraph:
    for fno, _wt, v in _fields(data):
        if fno == 7:
            return _parse_graph(v)
    raise ValueError("no graph in ONNX model")


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return parse_model(f.read())


# --------------------------------------------------------------- writer

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _f_len(fno: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(payload)) + payload


def _f_int(fno: int, v: int) -> bytes:
    return _varint(fno << 3) + _varint(v & ((1 << 64) - 1))


def _ser_tensor(name: str, arr: np.ndarray) -> bytes:
    dt = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
          np.dtype(np.float64): 11, np.dtype(np.int32): 6}[arr.dtype]
    out = b"".join(_f_int(1, d) for d in arr.shape)
    out += _f_int(2, dt)
    out += _f_len(8, name.encode())
    out += _f_len(9, np.ascontiguousarray(arr).tobytes())
    return out


def _ser_attr(name: str, val) -> bytes:
    out = _f_len(1, name.encode())
    if isinstance(val, (list, tuple)) and all(
            isinstance(x, (int, np.integer)) for x in val):
        for x in val:
            out += _f_int(8, int(x))
        out += _f_int(20, 7)
    elif isinstance(val, (int, np.integer)):
        out += _f_int(3, int(val))
        out += _f_int(20, 2)
    elif isinstance(val, float):
        out += _varint((2 << 3) | 5) + struct.pack("<f", val)
        out += _f_int(20, 1)
    elif isinstance(val, str):
        out += _f_len(4, val.encode())
        out += _f_int(20, 3)
    elif isinstance(val, np.ndarray):
        out += _f_len(5, _ser_tensor("", val))
        out += _f_int(20, 4)
    else:  # pragma: no cover
        raise ValueError(type(val))
    return out


def _ser_vi(name: str) -> bytes:
    return _f_len(1, name.encode())


def build_model(nodes: list[OnnxNode], initializers: dict,
                inputs: list[str], outputs: list[str]) -> bytes:
    g = b""
    for n in nodes:
        nb = b"".join(_f_len(1, s.encode()) for s in n.inputs)
        nb += b"".join(_f_len(2, s.encode()) for s in n.outputs)
        nb += _f_len(4, n.op_type.encode())
        nb += b"".join(_f_len(5, _ser_attr(k, v))
                       for k, v in n.attrs.items())
        g += _f_len(1, nb)
    for name, arr in initializers.items():
        g += _f_len(5, _ser_tensor(name, np.asarray(arr)))
    g += b"".join(_f_len(11, _ser_vi(s)) for s in inputs)
    g += b"".join(_f_len(12, _ser_vi(s)) for s in outputs)
    m = _f_int(1, 8)                       # ir_version
    m += _f_len(8, _f_int(2, 17))          # opset 17
    m += _f_len(7, g)
    return m


# -------------------------------------------------------------- executor

def _pair(v, n=2):
    if v is None:
        return (0,) * n
    return tuple(int(x) for x in v)


_CONV = {1: precision.conv1d, 2: precision.conv2d}
_CONV_T = {1: precision.conv_transpose1d, 2: precision.conv_transpose2d}
_POOL = {("AveragePool", 1): F.avg_pool1d, ("AveragePool", 2): F.avg_pool2d,
         ("MaxPool", 1): F.max_pool1d, ("MaxPool", 2): F.max_pool2d}
_BINARY = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div}
_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    (np.float32, torch.float32), (np.float64, torch.float64), (np.float16, torch.float16),
    (np.int64, torch.int64), (np.int32, torch.int32), (np.int8, torch.int8),
    (np.uint8, torch.uint8), (np.bool_, torch.bool))}


def _spatial_pad(pads: tuple, nd: int) -> list[int]:
    """ONNX (begin..., end...) pads -> F.pad's (last axis first) list."""
    out: list[int] = []
    for i in reversed(range(nd)):
        out += [pads[i], pads[nd + i]]
    return out


class OnnxRunner:
    """Execute a parsed graph with torch ops on the inputs' device.

    Static (shape-only or initializer-only) values are folded with numpy on
    the host; initializers reach the device once per device and are kept."""

    def __init__(self, graph: OnnxGraph):
        self.g = graph
        self._consts: dict = {}

    def _tensor(self, v, device, name: str | None = None):
        """``v`` as a tensor on ``device``; an initializer (``name``) reaches
        the device once per device and is kept."""
        if isinstance(v, torch.Tensor):
            return v
        key = (name, str(device))
        if name in self.g.initializers and key in self._consts:
            return self._consts[key]
        t = torch.tensor(np.asarray(v), device=device)
        if name in self.g.initializers:
            self._consts[key] = t
        return t

    def __call__(self, **inputs):
        env: dict[str, object] = dict(self.g.initializers)
        static: set[str] = set(self.g.initializers)
        env.update(inputs)
        device = next(v.device for v in inputs.values() if isinstance(v, torch.Tensor))

        def is_static(*names):
            return all((n == "" or n in static) for n in names)

        def S(name):  # static numpy value
            return np.asarray(env[name])

        def T(name):  # tensor value on the device
            return self._tensor(env[name], device, name)

        for node in self.g.nodes:
            op, a = node.op_type, node.attrs
            ins = node.inputs
            out = node.outputs[0]

            if op == "Constant":
                env[out] = np.asarray(a.get("value"))
                static.add(out)
                continue
            if op == "Shape" or (op in _STATIC_OPS and is_static(*ins)):
                env[out] = _static_eval(op, node, env)
                static.add(out)
                continue
            x = T(ins[0]) if ins and ins[0] else None

            if op == "Conv":
                w = T(ins[1])
                b = T(ins[2]) if len(ins) > 2 and ins[2] else None
                nd = w.dim() - 2
                pads = _pair(a.get("pads"), 2 * nd)
                if pads[:nd] != pads[nd:]:
                    x = F.pad(x, _spatial_pad(pads, nd))
                    pads = (0,) * (2 * nd)
                env[out] = _CONV[nd](x, w, b, _pair(a.get("strides", (1,) * nd), nd),
                                     pads[:nd], _pair(a.get("dilations", (1,) * nd), nd),
                                     int(a.get("group", 1)))
            elif op == "ConvTranspose":
                w = T(ins[1])   # (in, out/g, k...)
                b = T(ins[2]) if len(ins) > 2 and ins[2] else None
                nd = w.dim() - 2
                if int(a.get("group", 1)) != 1:
                    raise NotImplementedError("grouped ConvTranspose")
                strides = _pair(a.get("strides", (1,) * nd), nd)
                pads = _pair(a.get("pads"), 2 * nd)
                opad = _pair(a.get("output_padding", (0,) * nd), nd)
                # the full transposed conv, output_padding's zeros at the
                # end, then the (begin, end) pads cropped
                y = _CONV_T[nd](x, w, None, strides, 0)
                y = F.pad(y, _spatial_pad((0,) * nd + opad, nd))
                sl = [slice(None), slice(None)] + [
                    slice(pads[i], y.shape[2 + i] - pads[nd + i]) for i in range(nd)]
                y = y[tuple(sl)]
                env[out] = y if b is None else y + b.reshape((1, -1) + (1,) * nd)
            elif op == "BatchNormalization":
                sc, bi, mean, var = (S(n) for n in ins[1:5])
                eps = float(a.get("epsilon", 1e-5))
                shape = (1, -1) + (1,) * (x.dim() - 2)
                scale = sc.reshape(shape) / np.sqrt(var.reshape(shape) + eps)
                env[out] = (x - self._tensor(mean.reshape(shape), device)) * self._tensor(
                    scale, device) + self._tensor(bi.reshape(shape), device)
            elif op == "InstanceNormalization":
                sc, bi = (T(n) for n in ins[1:3])
                eps = float(a.get("epsilon", 1e-5))
                nd = x.dim() - 2
                ax = tuple(range(2, 2 + nd))
                mu = x.mean(dim=ax, keepdim=True)
                var = x.var(dim=ax, keepdim=True, unbiased=False)
                shape = (1, -1) + (1,) * nd
                env[out] = (x - mu) / torch.sqrt(var + eps) * sc.reshape(shape) \
                    + bi.reshape(shape)
            elif op == "Relu":
                env[out] = torch.clamp(x, min=0)
            elif op == "LeakyRelu":
                env[out] = torch.where(x > 0, x, float(a.get("alpha", 0.01)) * x)
            elif op == "Elu":
                env[out] = torch.where(x > 0, x, float(a.get("alpha", 1.0)) * (torch.exp(x) - 1))
            elif op == "Sigmoid":
                env[out] = 1.0 / (1.0 + torch.exp(-x))
            elif op == "Tanh":
                env[out] = torch.tanh(x)
            elif op in _BINARY:
                env[out] = _BINARY[op](x, T(ins[1]))
            elif op == "Concat":
                env[out] = torch.cat([T(n) for n in ins], dim=int(a["axis"]))
            elif op == "MatMul":
                env[out] = precision.matmul(x, T(ins[1]))
            elif op == "Gemm":
                y = T(ins[1])
                if int(a.get("transA", 0)):
                    x = x.transpose(-1, -2)
                if int(a.get("transB", 0)):
                    y = y.transpose(-1, -2)
                r = float(a.get("alpha", 1.0)) * precision.matmul(x, y)
                if len(ins) > 2 and ins[2]:
                    r = r + float(a.get("beta", 1.0)) * T(ins[2])
                env[out] = r
            elif op == "Reshape":
                shape = [int(v) for v in S(ins[1])]
                env[out] = x.reshape(_resolve_shape(shape, tuple(x.shape)))
            elif op == "Transpose":
                perm = a.get("perm") or list(reversed(range(x.dim())))
                env[out] = x.permute(*perm)
            elif op == "Unsqueeze":
                axes = a.get("axes") or [int(v) for v in S(ins[1])]
                for ax in sorted(int(v) for v in axes):
                    x = x.unsqueeze(ax)
                env[out] = x
            elif op == "Squeeze":
                axes = a.get("axes") or (
                    [int(v) for v in S(ins[1])] if len(ins) > 1 else None)
                env[out] = x.squeeze(tuple(axes)) if axes else x.squeeze()
            elif op == "Slice":
                env[out] = _slice(x, node, S, a)
            elif op == "Pad":
                if len(ins) > 1 and ins[1]:
                    pads = [int(v) for v in S(ins[1])]
                else:
                    pads = [int(v) for v in a["pads"]]
                nd = x.dim()
                mode = a.get("mode", "constant")
                inner = [i for i in range(nd) if pads[i] or pads[nd + i]]
                if mode == "constant" or not inner:
                    env[out] = F.pad(x, _spatial_pad(tuple(pads), nd))
                else:
                    # F.pad pads a non-constant mode over trailing axes only
                    lo = min(inner)
                    spatial = tuple(pads[lo:nd]) + tuple(pads[nd + lo:])
                    flat = x.reshape(-1, *x.shape[lo:]) if lo else x[None]
                    y = F.pad(flat, _spatial_pad(spatial, nd - lo),
                              mode={"reflect": "reflect", "edge": "replicate"}[mode])
                    env[out] = y.reshape(*x.shape[:lo], *y.shape[1:])
            elif op in ("AveragePool", "MaxPool"):
                nd = len(a["kernel_shape"])
                k = _pair(a["kernel_shape"], nd)
                s = _pair(a.get("strides", k), nd)
                pads = _pair(a.get("pads"), 2 * nd)
                fill = float("-inf") if op == "MaxPool" else 0.0
                # zero padding counts in the average (count_include_pad)
                x = F.pad(x, _spatial_pad(pads, nd), value=fill)
                env[out] = _POOL[(op, nd)](x, k, s)
            elif op == "GlobalAveragePool":
                env[out] = x.mean(dim=tuple(range(2, x.dim())), keepdim=True)
            elif op == "Softmax":
                env[out] = torch.softmax(x, dim=int(a.get("axis", -1)))
            elif op == "Cast":
                env[out] = x.to(_TORCH_DTYPES[np.dtype(_DTYPES.get(int(a["to"]), np.float32))])
            elif op == "Identity":
                env[out] = x
            elif op == "Clip":
                lo = float(S(ins[1])) if len(ins) > 1 and ins[1] else None
                hi = float(S(ins[2])) if len(ins) > 2 and ins[2] else None
                env[out] = torch.clamp(x, lo, hi)
            else:
                raise NotImplementedError(f"ONNX op {op}")

        return [T(n) for n in self.g.outputs]


_STATIC_OPS = {"Gather", "Concat", "Unsqueeze", "Squeeze", "Cast", "Slice",
               "Add", "Sub", "Mul", "Div", "Reshape", "Transpose"}


def _static_eval(op: str, node: OnnxNode, env: dict):
    a = node.attrs
    ins = node.inputs
    if op == "Shape":
        return np.asarray(tuple(env[ins[0]].shape), np.int64)
    vals = [np.asarray(env[n]) for n in ins if n]
    if op == "Gather":
        return np.take(vals[0], vals[1], axis=int(a.get("axis", 0)))
    if op == "Concat":
        return np.concatenate([np.atleast_1d(v) for v in vals],
                              axis=int(a.get("axis", 0)))
    if op == "Unsqueeze":
        axes = a.get("axes") or [int(v) for v in vals[1]]
        y = vals[0]
        for ax in sorted(int(v) for v in axes):
            y = np.expand_dims(y, ax)
        return y
    if op == "Squeeze":
        axes = a.get("axes") or ([int(v) for v in vals[1]]
                                 if len(vals) > 1 else None)
        return np.squeeze(vals[0], tuple(axes) if axes else None)
    if op == "Cast":
        return vals[0].astype(_DTYPES.get(int(a["to"]), np.float32))
    if op == "Reshape":
        return vals[0].reshape(_resolve_shape([int(v) for v in vals[1]],
                                              vals[0].shape))
    if op == "Transpose":
        return np.transpose(vals[0], a.get("perm"))
    if op in ("Add", "Sub", "Mul", "Div"):
        f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
             "Div": np.divide}[op]
        return f(vals[0], vals[1])
    if op == "Slice":
        return np.asarray(_slice(vals[0], node, lambda n: np.asarray(env[n]), a))
    raise NotImplementedError(op)  # pragma: no cover


def _resolve_shape(shape: list[int], in_shape) -> list[int]:
    out = list(shape)
    for i, v in enumerate(out):
        if v == 0:
            out[i] = in_shape[i]
    return out


def _slice(x, node: OnnxNode, S, a: dict):
    """ONNX Slice of a numpy array or a tensor (positive steps)."""
    ins = node.inputs
    if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = [int(v) for v in S(ins[1])]
        ends = [int(v) for v in S(ins[2])]
        axes = ([int(v) for v in S(ins[3])] if len(ins) > 3 and ins[3]
                else list(range(len(starts))))
        steps = ([int(v) for v in S(ins[4])] if len(ins) > 4 and ins[4]
                 else [1] * len(starts))
    else:
        starts = [int(v) for v in a["starts"]]
        ends = [int(v) for v in a["ends"]]
        axes = [int(v) for v in a.get("axes", range(len(starts)))]
        steps = [1] * len(starts)
    nd = len(x.shape)
    sl = [slice(None)] * nd
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if ax < 0:
            ax += nd
        en = min(en, x.shape[ax]) if en >= 0 else en
        sl[ax] = slice(st, en, sp)
    return x[tuple(sl)]
