"""repro_torch.quantize — QONNX-semantics fake quantization for the LM
models, trained through with straight-through gradients (QAT), and PTQ
calibration."""
from .config import FP32, W2A2, W4A4, W4A8, W8A8, QuantRecipe, TensorQuant  # noqa: F401
from .layers import qeinsum, qlinear, quant_act, quant_kv, quant_weight  # noqa: F401
from . import calibrate  # noqa: F401
