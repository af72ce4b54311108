"""repro_torch.models — the QONNX model zoo."""
