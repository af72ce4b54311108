"""Node-level execution engine for QonnxGraph: the paper's §V oracle in PyTorch.

Counterpart of ``repro.core.executor``: "model execution is based on a
node-level execution in Python ... not meant to provide high performance,
but to ensure that model outputs can be verified through execution."
Every op runs as plain PyTorch on the device of its inputs; the compiled
tier (``compile.py``) uses this registry for the nodes no lowering rule
covers and is held against ``execute`` as its oracle.

Numbers follow the reference, which runs JAX with 64-bit types off: every
int64 / float64 array that enters the engine (initializers, inputs,
``Constant`` values, ``Cast`` targets) becomes int32 / float32, and
``Shape`` yields int32.  Shape inference (``transforms.infer_shapes``)
records these dtypes, so the port's serialized graphs read like the
reference's.

Channels-last execution: shape-dependent ops (Conv, pools,
BatchNormalization, MultiThreshold) honor a ``data_layout`` attribute
("NCHW" default, "NHWC" after the channels-last transform).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import quant_ops
from .graph import Node, QonnxGraph

OpFn = Callable[..., object]
_OP_REGISTRY: dict[tuple[str, str], OpFn] = {}

# 64-bit types narrow as they do under JAX's default (x64 off)
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}
_NARROW_TORCH = {torch.int64: torch.int32, torch.float64: torch.float32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def to_tensor(v, device=None) -> torch.Tensor:
    """numpy array / scalar / tensor -> tensor on ``device`` with 64-bit
    types narrowed to 32 bits (see module docstring)."""
    if isinstance(v, torch.Tensor):
        t = v
        if t.dtype in _NARROW_TORCH:
            t = t.to(_NARROW_TORCH[t.dtype])
    else:
        a = np.asarray(v)
        a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
        t = torch.from_numpy(np.asarray(a, order="C"))
    return t if device is None else t.to(device)


def torch_dtype(name) -> torch.dtype:
    """A numpy dtype name ("float32", "int8", ...) -> the torch dtype the
    engine uses for it (64-bit types narrowed)."""
    a = np.dtype(name)
    return torch.from_numpy(np.zeros(0, _NARROW.get(a, a))).dtype


def dtype_name(t: torch.Tensor) -> str:
    """The numpy-style dtype string of a tensor ("float32", not
    "torch.float32") — the form the reference writes into value_info."""
    return str(t.dtype).replace("torch.", "")


def register_op(op_type: str, domain: str = ""):
    def deco(fn):
        _OP_REGISTRY[(op_type, domain)] = fn
        return fn
    return deco


def lookup_op(node: Node) -> OpFn:
    key = (node.op_type, node.domain)
    if key in _OP_REGISTRY:
        return _OP_REGISTRY[key]
    # domain-less registration (frontends sometimes export QONNX ops that way)
    if (node.op_type, "") in _OP_REGISTRY:
        return _OP_REGISTRY[(node.op_type, "")]
    # any-domain match, lowest domain string wins (deterministic)
    candidates = sorted(dom for (op, dom) in _OP_REGISTRY
                        if op == node.op_type)
    if candidates:
        return _OP_REGISTRY[(node.op_type, candidates[0])]
    raise NotImplementedError(f"no executor for op {node.op_type!r} (domain {node.domain!r})")


def execute(graph: QonnxGraph, inputs: dict, return_all: bool = False,
            device=None) -> dict:
    """Execute the graph node-by-node; returns {output_name: tensor}.

    ``device=None`` runs on CUDA (and raises without a GPU); pass
    ``device="cpu"`` to run on the host."""
    dev = resolve_device(device)
    env: dict[str, object] = {k: to_tensor(v, dev)
                              for k, v in graph.initializers.items()}
    for t in graph.inputs:
        if t.name not in inputs:
            raise ValueError(f"missing graph input {t.name!r}")
    env.update({k: to_tensor(v, dev) for k, v in inputs.items()})
    return run_nodes(graph, env, return_all)


def run_nodes(graph: QonnxGraph, env: dict, return_all: bool = False) -> dict:
    """Run every node of ``graph`` in topological order over ``env``."""
    for node in graph.toposort():
        out = op_output(node, [env[i] if i else None for i in node.inputs])
        for name, val in zip(node.outputs, out):
            env[name] = val
    if return_all:
        return env
    return {name: env[name] for name in graph.output_names}


def _values(t) -> np.ndarray:
    """Concrete host values of an operand that must be static (shapes,
    axes, pads)."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------------------------
# QONNX domain ops (the paper's contribution)
# --------------------------------------------------------------------------

@register_op("Quant", "qonnx.custom_op.general")
def _quant(node, x, scale, zero_point, bit_width):
    return quant_ops.quant(
        x, scale, zero_point, bit_width,
        signed=bool(node.attrs.get("signed", 1)),
        narrow=bool(node.attrs.get("narrow", 0)),
        rounding_mode=node.attrs.get("rounding_mode", "ROUND"))


@register_op("BipolarQuant", "qonnx.custom_op.general")
def _bipolar_quant(node, x, scale):
    return quant_ops.bipolar_quant(x, scale)


@register_op("Trunc", "qonnx.custom_op.general")
def _trunc(node, x, scale, zero_point, in_bits, out_bits):
    return quant_ops.trunc(
        x, scale, zero_point, in_bits, out_bits,
        rounding_mode=node.attrs.get("rounding_mode", "FLOOR"),
        signed=bool(node.attrs.get("signed", 1)))


def _channel_shape(node, x, n_channels: int) -> list:
    layout = node.attrs.get("data_layout", "NCHW")
    shape = [1] * x.ndim
    shape[1 if layout == "NCHW" else x.ndim - 1] = n_channels
    return shape


@register_op("MultiThreshold", "finn.custom_op.general")
def _multithreshold(node, x, thresholds):
    """FINN-style multistep activation: y = sum_i (x >= T[c, i]);
    out = out_scale * y + out_bias.  thresholds: (channels, n_steps)."""
    shape = _channel_shape(node, x, thresholds.shape[0])
    acc = torch.zeros_like(x)
    for i in range(thresholds.shape[1]):
        acc = acc + (x >= thresholds[:, i].reshape(shape)).to(x.dtype)
    scale = node.attrs.get("out_scale", 1.0)
    bias = node.attrs.get("out_bias", 0.0)
    return scale * acc + bias


# --------------------------------------------------------------------------
# Standard ONNX ops (the subset the zoo + transforms need)
# --------------------------------------------------------------------------

@register_op("QuantizeLinear")
def _quantize_linear(node, x, scale, zero_point=None):
    signed = zero_point is not None and zero_point.dtype.is_signed and \
        not zero_point.dtype.is_floating_point
    qmin, qmax = (-128, 127) if signed else (0, 255)
    zp = 0 if zero_point is None else zero_point
    y = torch.round(x / scale) + torch.as_tensor(zp, dtype=x.dtype,
                                                 device=x.device)
    y = torch.clamp(y, qmin, qmax)
    return y.to(torch.int8 if signed else torch.uint8)


@register_op("DequantizeLinear")
def _dequantize_linear(node, y, scale, zero_point=None):
    zp = 0 if zero_point is None else zero_point
    return (y.to(torch.float32) - torch.as_tensor(
        zp, dtype=torch.float32, device=y.device)) * scale


@register_op("Clip")
def _clip(node, x, lo=None, hi=None):
    lo = node.attrs.get("min", -np.inf) if lo is None else lo
    hi = node.attrs.get("max", np.inf) if hi is None else hi
    return torch.clamp(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device),
                       torch.as_tensor(hi, dtype=x.dtype, device=x.device))


@register_op("Constant")
def _constant(node):
    return to_tensor(node.attrs["value"])


@register_op("Identity")
def _identity(node, x):
    return x


@register_op("Cast")
def _cast(node, x):
    return x.to(torch_dtype(node.attrs.get("to", "float32")))


def _promote(a, b):
    """numpy-style result dtype for two operands (torch ops that need equal
    dtypes — matmul, concat — get them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _binary(fn):
    def op(node, a, b):
        return fn(a, b)
    return op


register_op("Add")(_binary(torch.add))
register_op("Sub")(_binary(torch.sub))
register_op("Mul")(_binary(torch.mul))
register_op("Div")(_binary(torch.true_divide))
register_op("MatMul")(_binary(lambda a, b: torch.matmul(*_promote(a, b))))
register_op("Pow")(_binary(torch.pow))


@register_op("Gemm")
def _gemm(node, a, b, c=None):
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    y = alpha * torch.matmul(*_promote(a, b))
    if c is not None:
        y = y + beta * c
    return y


@register_op("MatMulInteger")
def _matmul_integer(node, a, b, a_zp=None, b_zp=None):
    a32 = a.to(torch.int32) - (0 if a_zp is None else a_zp.to(torch.int32))
    b32 = b.to(torch.int32) - (0 if b_zp is None else b_zp.to(torch.int32))
    return torch.matmul(a32, b32)


@register_op("Relu")
def _relu(node, x):
    return torch.relu(x)


@register_op("Sigmoid")
def _sigmoid(node, x):
    return torch.sigmoid(x)


@register_op("Tanh")
def _tanh(node, x):
    return torch.tanh(x)


@register_op("Erf")
def _erf(node, x):
    return torch.special.erf(x)


@register_op("Softmax")
def _softmax(node, x):
    return torch.softmax(x, dim=node.attrs.get("axis", -1))


@register_op("Reshape")
def _reshape(node, x, shape):
    target = [int(d) for d in _values(shape).astype(np.int64).reshape(-1)]
    # ONNX semantics: 0 = copy dim from input
    target = [int(x.shape[i]) if d == 0 else d for i, d in enumerate(target)]
    return torch.reshape(x, target)


@register_op("Transpose")
def _transpose(node, x):
    perm = node.attrs.get("perm")
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    return x.permute(*[int(p) for p in perm])


@register_op("Flatten")
def _flatten(node, x):
    axis = node.attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return torch.reshape(x, (lead, -1))


@register_op("Concat")
def _concat(node, *xs):
    dt = xs[0].dtype
    for v in xs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return torch.cat([v.to(dt) for v in xs], dim=node.attrs.get("axis", 0))


@register_op("Shape")
def _shape(node, x):
    return torch.tensor(list(x.shape), dtype=torch.int32,
                        device=x.device if x.device.type != "meta" else "cpu")


@register_op("Gather")
def _gather(node, x, idx):
    axis = node.attrs.get("axis", 0)
    axis = axis + x.ndim if axis < 0 else axis
    idx = idx.to(device=x.device, dtype=torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def _axes(node, axes):
    ax = node.attrs.get("axes") if axes is None else _values(axes).tolist()
    if ax is None:
        return None
    return [int(ax)] if not isinstance(ax, (list, tuple)) else \
        [int(v) for v in ax]


@register_op("Unsqueeze")
def _unsqueeze(node, x, axes=None):
    y = x
    for a in sorted(_axes(node, axes)):
        y = torch.unsqueeze(y, a)
    return y


@register_op("Squeeze")
def _squeeze(node, x, axes=None):
    ax = _axes(node, axes)
    if ax is None:
        return torch.squeeze(x)
    for a in sorted((a + x.ndim if a < 0 else a for a in ax), reverse=True):
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of shape {tuple(x.shape)}")
        x = torch.squeeze(x, a)
    return x


def _true_div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as an IEEE division, as the reference's pools divide.  The
    divisor is a tensor on ``x``'s device: divided by a Python number, a
    CUDA tensor is multiplied by the reciprocal, which can be 1 ulp off."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _mean(x: torch.Tensor, axes: tuple, keep: bool) -> torch.Tensor:
    """The reference's ``jnp.mean``: the sum over ``axes``, then a multiply
    by the float32 reciprocal of the count, which is what XLA makes of
    jnp.mean's division by a constant.  Spelled out, so the CPU and CUDA
    results agree (``torch.mean`` divides on the CPU and multiplies on
    CUDA)."""
    n = int(np.prod([x.shape[a] for a in axes]))
    recip = torch.full((), np.float32(1.0) / np.float32(n), dtype=x.dtype,
                       device=x.device)
    return torch.sum(x, dim=axes, keepdim=keep) * recip


@register_op("ReduceMean")
def _reduce_mean(node, x):
    axes = node.attrs.get("axes")
    keep = bool(node.attrs.get("keepdims", 1))
    if not axes:
        return _mean(x, tuple(range(x.ndim)), keep)
    return _mean(x, tuple(int(a) % x.ndim for a in axes), keep)


@register_op("BatchNormalization")
def _batchnorm(node, x, gamma, beta, mean, var):
    eps = node.attrs.get("epsilon", 1e-5)
    shape = _channel_shape(node, x, x.shape[1 if node.attrs.get(
        "data_layout", "NCHW") == "NCHW" else x.ndim - 1])
    g, b = gamma.reshape(shape), beta.reshape(shape)
    m, v = mean.reshape(shape), var.reshape(shape)
    return g * (x - m) / torch.sqrt(v + eps) + b


def _to_nchw(x):
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _to_nhwc(x):
    return x.permute(0, *range(2, x.ndim), 1)


def _torch_pads(pad_pairs) -> list:
    """[(before, after)] per spatial dim -> F.pad's last-dim-first list."""
    out = []
    for before, after in reversed(pad_pairs):
        out += [before, after]
    return out


@register_op("Conv")
def _conv(node, x, w, b=None):
    nhwc = node.attrs.get("data_layout", "NCHW") == "NHWC"
    nsp = x.ndim - 2
    strides = [int(s) for s in node.attrs.get("strides", [1] * nsp)]
    dil = [int(d) for d in node.attrs.get("dilations", [1] * nsp)]
    group = int(node.attrs.get("group", 1))
    pads = node.attrs.get("pads", [0] * (2 * nsp))
    pad_pairs = [(int(pads[i]), int(pads[i + nsp])) for i in range(nsp)]
    xc = _to_nchw(x) if nhwc else x          # weights stay OIHW either way
    if any(p for pair in pad_pairs for p in pair):
        xc = F.pad(xc, _torch_pads(pad_pairs))
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nsp]
    # the reference's convolution is a true fp32 one: keep cuDNN off TF32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = conv(xc, w.to(x.dtype), None, strides, 0, dil, group)
    if b is not None:
        y = y + b.reshape([1, -1] + [1] * nsp).to(y.dtype)
    return _to_nhwc(y) if nhwc else y


def _pool(node, x, is_avg: bool):
    nhwc = node.attrs.get("data_layout", "NCHW") == "NHWC"
    nsp = x.ndim - 2
    k = [int(v) for v in node.attrs.get("kernel_shape", [1] * nsp)]
    strides = [int(v) for v in node.attrs.get("strides", list(k))]
    pads = node.attrs.get("pads", [0] * (2 * nsp))
    pad_pairs = [(int(pads[i]), int(pads[i + nsp])) for i in range(nsp)]
    xc = _to_nchw(x) if nhwc else x
    if nsp == 1:                              # pool 1-D as 2-D with H = 1
        xc, k, strides, pad_pairs = (xc[:, :, None], [1] + k, [1] + strides,
                                     [(0, 0)] + pad_pairs)
    padded = any(p for pair in pad_pairs for p in pair)
    tp = _torch_pads(pad_pairs)
    if not is_avg:
        xp = F.pad(xc, tp, value=-float("inf")) if padded else xc
        y = F.max_pool2d(xp, k, strides)
    else:
        # window sums, then a true division by the element count
        xp = F.pad(xc, tp) if padded else xc
        y = F.avg_pool2d(xp, k, strides, divisor_override=1)
        if padded and not bool(node.attrs.get("count_include_pad", 0)):
            # ONNX default count_include_pad=0: padded positions do not
            # count toward the divisor
            ones = F.pad(torch.ones_like(xc[:1, :1]), tp)
            y = y / F.avg_pool2d(ones, k, strides, divisor_override=1)
        else:
            y = _true_div(y, float(np.prod(k)))
    if nsp == 1:
        y = y[:, :, 0]
    return _to_nhwc(y) if nhwc else y


@register_op("MaxPool")
def _maxpool(node, x):
    return _pool(node, x, is_avg=False)


@register_op("AveragePool")
def _avgpool(node, x):
    return _pool(node, x, is_avg=True)


@register_op("GlobalAveragePool")
def _gap(node, x):
    layout = node.attrs.get("data_layout", "NCHW")
    axes = tuple(range(2, x.ndim)) if layout == "NCHW" else tuple(range(1, x.ndim - 1))
    return _mean(x, axes, True)


@register_op("Pad")
def _pad(node, x, pads=None, value=None):
    p = _values(node.attrs.get("pads") if pads is None else pads).astype(int)
    n = x.ndim
    pairs = [(int(p[i]), int(p[i + n])) for i in range(n)]
    v = 0.0 if value is None else float(_values(value).reshape(-1)[0])
    return F.pad(x, _torch_pads(pairs), value=v)


def op_output(node: Node, args: list) -> tuple:
    """Run one node's op on ``args``; always returns a tuple of outputs."""
    out = lookup_op(node)(node, *args)
    return out if isinstance(out, tuple) else (out,)


__all__ = ["execute", "lookup_op", "register_op", "resolve_device",
           "to_tensor", "op_output", "dtype_name", "torch_dtype"]
