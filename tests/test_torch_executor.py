"""The port's §V oracle (``repro_torch.core.execute``) against the reference
executor: op by op as parametrized single-node graphs, then whole zoo
graphs.

Tolerances: exact for every op whose result is a rounding of exact
arithmetic; ``rtol=atol=1e-6`` for transcendental ops and float
reductions (convolution, pooling sums, means, softmax), where the two
libraries' kernels sum or approximate differently.  Whole graphs: TFC is
bit-exact (dyadic scales, exact sums); CNV and MobileNet are held to the
reference's own tie-flip envelope (``tests/test_compile.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GraphBuilder as RBuilder  # noqa: E402
from repro.core import execute as r_execute  # noqa: E402
from repro.core import transforms as rtr  # noqa: E402
from repro.models import zoo as rzoo  # noqa: E402
from repro_torch.core import GraphBuilder as TBuilder  # noqa: E402
from repro_torch.core import execute as t_execute  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from test_compile import assert_zoo_parity  # noqa: E402

QD, FD = "qonnx.custom_op.general", "finn.custom_op.general"
R = np.random.RandomState(0)


def f32(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def i64(*v):
    return np.asarray(v, np.int64)


# (id, op_type, domain, x, extra operands (initializers), attrs, exact)
CASES = [
    ("add", "Add", "", f32(3, 4), [f32(3, 4)], {}, True),
    ("sub_bcast", "Sub", "", f32(3, 4), [f32(4)], {}, True),
    ("mul", "Mul", "", f32(3, 4), [f32(1, 4)], {}, True),
    ("div", "Div", "", f32(3, 4), [f32(3, 4) + 3.0], {}, True),
    ("pow", "Pow", "", np.abs(f32(3, 4)) + 0.5, [np.float32(1.5)], {}, False),
    ("matmul", "MatMul", "", f32(3, 8), [f32(8, 5)], {}, False),
    ("gemm", "Gemm", "", f32(8, 3), [f32(5, 8), f32(5)],
     {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0}, False),
    ("matmul_integer", "MatMulInteger", "",
     R.randint(-8, 8, (3, 6)).astype(np.int8),
     [R.randint(-8, 8, (6, 4)).astype(np.int8)], {}, True),
    ("relu", "Relu", "", f32(5, 6), [], {}, True),
    ("sigmoid", "Sigmoid", "", f32(5, 6), [], {}, False),
    ("tanh", "Tanh", "", f32(5, 6), [], {}, False),
    ("erf", "Erf", "", f32(5, 6), [], {}, False),
    ("softmax", "Softmax", "", f32(5, 6), [], {"axis": 1}, False),
    ("reshape", "Reshape", "", f32(2, 3, 4), [i64(0, -1)], {}, True),
    ("transpose", "Transpose", "", f32(2, 3, 4), [], {"perm": [2, 0, 1]},
     True),
    ("flatten", "Flatten", "", f32(2, 3, 4, 5), [], {"axis": 2}, True),
    ("concat", "Concat", "", f32(2, 3), [f32(2, 5)], {"axis": 1}, True),
    ("shape", "Shape", "", f32(2, 3, 4), [], {}, True),
    ("gather", "Gather", "", f32(3, 5), [i64(4, -1, 0)], {"axis": 1}, True),
    ("gather_scalar", "Gather", "", f32(3, 5), [np.asarray(2, np.int64)],
     {"axis": 0}, True),
    ("unsqueeze", "Unsqueeze", "", f32(3, 4), [], {"axes": [0, 2]}, True),
    ("unsqueeze_input", "Unsqueeze", "", f32(3, 4), [i64(1)], {}, True),
    ("squeeze", "Squeeze", "", f32(3, 1, 4, 1), [], {"axes": [1]}, True),
    ("squeeze_all", "Squeeze", "", f32(3, 1, 4, 1), [], {}, True),
    ("reduce_mean", "ReduceMean", "", f32(3, 4, 5), [],
     {"axes": [1], "keepdims": 0}, False),
    ("batchnorm", "BatchNormalization", "", f32(2, 3, 4, 4),
     [f32(3), f32(3), f32(3), np.abs(f32(3)) + 0.5], {}, False),
    ("conv", "Conv", "", f32(2, 4, 9, 9), [f32(6, 2, 3, 3), f32(6)],
     {"strides": [2, 1], "pads": [1, 0, 2, 1], "dilations": [1, 2],
      "group": 2}, False),
    ("conv_nhwc", "Conv", "", f32(2, 8, 8, 3), [f32(5, 3, 3, 3)],
     {"pads": [1, 1, 1, 1], "data_layout": "NHWC"}, False),
    ("conv1d", "Conv", "", f32(2, 3, 11), [f32(4, 3, 3)],
     {"pads": [1, 1], "strides": [2]}, False),
    ("maxpool_pads", "MaxPool", "", f32(2, 3, 7, 7), [],
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}, True),
    ("maxpool_nhwc", "MaxPool", "", f32(2, 6, 6, 3), [],
     {"kernel_shape": [2, 2], "data_layout": "NHWC"}, True),
    ("avgpool", "AveragePool", "", f32(2, 3, 8, 8), [],
     {"kernel_shape": [2, 2], "strides": [2, 2]}, False),
    ("avgpool_pads_exclude", "AveragePool", "", f32(2, 3, 7, 7), [],
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]},
     False),
    ("avgpool_pads_include", "AveragePool", "", f32(2, 3, 7, 7), [],
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
      "count_include_pad": 1}, False),
    ("avgpool1d", "AveragePool", "", f32(2, 3, 9), [],
     {"kernel_shape": [3], "strides": [2], "pads": [1, 0]}, False),
    ("gap", "GlobalAveragePool", "", f32(2, 3, 5, 5), [], {}, False),
    ("pad_attr", "Pad", "", f32(2, 3), [], {"pads": [1, 0, 0, 2]}, True),
    ("pad_value", "Pad", "", f32(2, 3), [i64(0, 1, 2, 0),
                                         np.asarray(1.5, np.float32)], {},
     True),
    ("clip_attrs", "Clip", "", f32(3, 4), [], {"min": -0.5, "max": 0.7},
     True),
    ("clip_inputs", "Clip", "", f32(3, 4),
     [np.asarray(-1.0, np.float32), np.asarray(0.25, np.float32)], {}, True),
    ("cast_int", "Cast", "", f32(3, 4, scale=5), [], {"to": "int32"}, True),
    ("cast_int64", "Cast", "", f32(3, 4, scale=5), [], {"to": "int64"},
     True),
    ("identity", "Identity", "", f32(3, 4), [], {}, True),
    ("quantize_linear_s8", "QuantizeLinear", "", f32(3, 4, scale=20),
     [np.float32(0.3), np.asarray(3, np.int8)], {}, True),
    ("quantize_linear_u8", "QuantizeLinear", "", f32(3, 4, scale=20),
     [np.float32(0.3)], {}, True),
    ("dequantize_linear", "DequantizeLinear", "",
     R.randint(-128, 128, (3, 4)).astype(np.int8),
     [np.float32(0.3), np.asarray(-2, np.int8)], {}, True),
    ("multithreshold", "MultiThreshold", FD, f32(2, 3, 4),
     [np.sort(f32(3, 5), axis=1)], {"out_scale": 0.5, "out_bias": -1.0},
     True),
    ("quant", "Quant", QD, f32(3, 8, scale=3),
     [np.float32(0.2), np.float32(1.0), np.float32(4)],
     {"signed": 0, "narrow": 1, "rounding_mode": "HALF_UP"}, True),
    ("quant_channel", "Quant", QD, f32(3, 8, scale=3),
     [np.abs(f32(8)) + 0.1, np.zeros(8, np.float32), np.float32(3)], {},
     True),
    ("bipolar_quant", "BipolarQuant", QD, f32(3, 8), [np.float32(0.5)], {},
     True),
    ("trunc", "Trunc", QD,
     (R.randint(-128, 128, (3, 8)) * 0.125).astype(np.float32),
     [np.float32(0.125), np.float32(0), np.float32(8), np.float32(5)],
     {"rounding_mode": "ROUND"}, True),
]


def _single_node(builder, op, domain, x, extras, attrs):
    b = builder(f"single_{op}")
    xin = b.add_input("x", x.shape, str(x.dtype))
    names = [b.add_initializer("c", e) for e in extras]
    (y,) = b.add_node(op, [xin] + names, 1, dict(attrs), domain=domain)
    b.mark_output(y)
    return b.build()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    _, op, domain, x, extras, attrs, exact = case
    g_ref = _single_node(RBuilder, op, domain, x, extras, attrs)
    g_port = _single_node(TBuilder, op, domain, x, extras, attrs)
    ref = np.asarray(r_execute(g_ref, {"x": x})[g_ref.output_names[0]])
    got = t_execute(g_port, {"x": x}, device="cpu")[g_port.output_names[0]]
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_constant_node_and_unknown_op():
    for builder in (RBuilder, TBuilder):
        b = builder("const")
        x = b.add_input("x", (2, 3))
        (c,) = b.add_node("Constant", [], 1,
                          {"value": np.arange(3, dtype=np.float64)})
        (y,) = b.add_node("Add", [x, c], 1)
        b.mark_output(y)
        g = b.build()
        xv = f32(2, 3)
        out = (t_execute(g, {"x": xv}, device="cpu") if builder is TBuilder
               else r_execute(g, {"x": xv}))[y]
        np.testing.assert_array_equal(np.asarray(out),
                                      xv + np.arange(3, dtype=np.float32))
    b = TBuilder("bad")
    x = b.add_input("x", (2,))
    (y,) = b.add_node("NoSuchOp", [x], 1)
    b.mark_output(y)
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        t_execute(b.build(), {"x": f32(2)}, device="cpu")


def test_missing_input_and_cuda_default():
    g = tzoo.build_tfc(1, 1)
    with pytest.raises(ValueError, match="missing graph input"):
        t_execute(g, {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_execute(g, {"x": f32(1, 784)})


# ------------------------------------------------------------- whole graphs

def _both(key, build_ref, build_port, x):
    g_ref = rtr.cleanup(build_ref())
    g_port = ttr.cleanup(build_port())
    ref = np.asarray(r_execute(g_ref, {"x": x})[g_ref.output_names[0]])
    got = t_execute(g_port, {"x": x}, device="cpu")[g_port.output_names[0]]
    return ref, got.numpy()


@pytest.mark.parametrize("key", ["TFC-w1a1", "TFC-w1a2", "TFC-w2a2"])
def test_tfc_oracle_bit_exact(key):
    x = np.random.RandomState(1).randn(6, 784).astype(np.float32)
    ref, got = _both(key, rzoo.ZOO[key], tzoo.ZOO[key], x)
    np.testing.assert_array_equal(got, ref)


def test_cnv_w1a1_oracle_within_envelope():
    x = np.random.RandomState(2).rand(2, 3, 32, 32).astype(np.float32)
    ref, got = _both("CNV-w1a1", rzoo.ZOO["CNV-w1a1"], tzoo.ZOO["CNV-w1a1"],
                     x)
    assert got.shape == ref.shape
    assert_zoo_parity(ref, got, mean_steps=1.5)


def test_mobilenet_img32_oracle_within_envelope():
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    ref, got = _both("MobileNet", lambda: rzoo.build_mobilenet(img=32),
                     lambda: tzoo.build_mobilenet(img=32), x)
    assert got.shape == ref.shape == (1, 1000)
    assert_zoo_parity(ref, got, act_step=0.125, mean_steps=1.5)
