"""repro_torch.models — the QONNX model zoo and the LM architectures
(dense family)."""
