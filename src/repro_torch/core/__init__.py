"""repro_torch.core — the QONNX dialect and graph toolchain in PyTorch."""
from .quant_ops import (  # noqa: F401
    ROUNDING_MODES,
    bipolar_quant,
    dequantize_int,
    int_repr,
    max_int,
    min_int,
    quant,
    quantize_int,
    round_shift,
    round_with_mode,
    scale_from_minmax,
    trunc,
)
from .ste import bipolar_quant_ste, fake_quant, quant_ste  # noqa: F401
from .graph import GraphBuilder, Node, QonnxGraph, TensorInfo  # noqa: F401
from .executor import execute, register_op  # noqa: F401
from . import export, formats, passes, serialize, streamline, transforms  # noqa: F401
from . import compile as compile_  # noqa: F401  ("compile" shadows a builtin)
from .compile import CompiledPlan, compile_graph, execute_compiled  # noqa: F401
from .passes import PassManager, register_pass, run_pipeline  # noqa: F401
