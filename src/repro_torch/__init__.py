"""repro_torch — the QONNX reproduction ported to PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``, with the same module
paths.  It imports torch, numpy and the standard library only.  Entry
points (``core.execute``, ``core.compile_graph``,
``serve.CompiledGraphEngine``) run on CUDA unless given ``device="cpu"``;
the kernels in ``kernels/`` are CUDA C++ built with ``nvcc`` at first use,
and each wrapper runs its plain PyTorch twin for tensors on the CPU.
"""
