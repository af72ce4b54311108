"""Declarative lowering-rule registry for the compiled executor.

See ``base.py`` for the rule protocol and ``core/compile.py`` for the
partitioner that drives it.  Importing this package registers the rules
ported so far (matmul, grouped / depthwise conv, im2col conv, activation
QDQ, QCDQ chain).
"""
from .base import (  # noqa: F401
    LoweringContext, LoweringRule, Match, Segment, col_scale,
    conv_channel_scale, conv_out_rows, get_rule, iter_rules, register_rule,
    rules_for, scalar, sole_consumer, static_value, tensor_rows,
    unregister_rule)
from .weights import (  # noqa: F401
    KernelMatch, QuantWeight, chain_absorbable, resolve_quant_weight)

# importing the rule modules registers the rules
from . import conv as _conv          # noqa: F401,E402
from . import grouped_conv as _grouped_conv  # noqa: F401,E402
from . import matmul as _matmul      # noqa: F401,E402
from . import qdq as _qdq            # noqa: F401,E402

from .conv import ActQuantParams, QuantConvRule, match_conv_common  # noqa: F401,E402
from .grouped_conv import MAX_BLOCKED_GROUPS, GroupedConvRule  # noqa: F401,E402
from .matmul import QuantMatMulRule  # noqa: F401,E402
from .qdq import ActivationQuantRule, QCDQChainRule  # noqa: F401,E402
