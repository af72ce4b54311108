"""repro_torch.models — the QONNX model zoo and the LM architectures
(dense, moe, vlm, audio, ssm and hybrid families)."""
from .common import ModelConfig  # noqa: F401
from . import api  # noqa: F401
