"""Declarative lowering-rule registry for the compiled executor.

See ``base.py`` for the rule protocol and ``core/compile.py`` for the
partitioner that drives it.  Importing this package registers the rules
ported so far (matmul, activation QDQ, QCDQ chain).
"""
from .base import (  # noqa: F401
    LoweringContext, LoweringRule, Match, Segment, col_scale, get_rule,
    iter_rules, register_rule, rules_for, scalar, sole_consumer,
    static_value, unregister_rule)
from .weights import (  # noqa: F401
    KernelMatch, QuantWeight, chain_absorbable, resolve_quant_weight)

# importing the rule modules registers the rules
from . import matmul as _matmul      # noqa: F401,E402
from . import qdq as _qdq            # noqa: F401,E402

from .matmul import QuantMatMulRule  # noqa: F401,E402
from .qdq import ActivationQuantRule, QCDQChainRule  # noqa: F401,E402
