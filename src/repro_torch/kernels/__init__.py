"""repro_torch.kernels — hand-written Hopper kernels (CUDA C++ in ``csrc/``)
with plain PyTorch twins.  Nothing here builds or loads CUDA code at import
time: ``_build.load`` compiles the sources at the first launch."""
