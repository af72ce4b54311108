"""Arbitrary-precision range & datatype analysis over QonnxGraph.

Counterpart of ``repro.analysis``: numpy over the graph, with constant
subgraphs evaluated by the port's own oracle on the CPU.

The compiler-style analysis tier (cf. Jain et al., "Efficient Execution of
Quantized Deep Learning Models: A Compiler Approach"):

  * ``datatypes``  — INT<N>/UINT<N>/BIPOLAR/FLOAT32 datatype lattice
  * ``ranges``     — forward integer range analysis + quantization-grid
                     tracking + minimal accumulator bit widths
  * ``infer``      — datatype inference pass (annotates value_info)
  * ``validate``   — quantization-consistency validator
  * ``cost``       — inference-cost reporting (subsumes core/bops.py)
  * ``report``     — ``python -m repro_torch.analysis.report`` CLI

Consumers: ``core/compile.py`` (kernel-variant and accumulator-dtype
selection), the registered ``infer_datatypes`` / ``validate_quantization``
passes, and ``serve.CompiledGraphEngine`` (per-model cost at load).
"""
from .cost import CostReport, LayerReport, infer_cost  # noqa: F401
from .datatypes import BIPOLAR, FLOAT32, DataType  # noqa: F401
from .infer import (infer_datatype_map, infer_datatypes,  # noqa: F401
                    infer_dyadic_map)
from .ranges import (DYADIC_MAX_MULT, AccumulatorSpec,  # noqa: F401
                     GraphAnalysis, QuantGrid, RangeInfo, analyze,
                     dyadic_decompose, is_power_of_two)
from .validate import (QuantValidationError, ValidationIssue,  # noqa: F401
                       check_graph, validate_quantization)
