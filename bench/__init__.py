"""The benchmark of the PyTorch and CUDA port (``repro_torch``).  Entry
point: ``python bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
