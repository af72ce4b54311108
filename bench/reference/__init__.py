"""The benchmark's plain reference: QONNX's operators and the models' forward
pass in plain PyTorch, computed again from the arrays the benchmark hands it.
Imports nothing of the program."""
