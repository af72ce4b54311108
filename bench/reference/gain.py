"""The power-of-two gain a quantized conv's weights get, frozen here.

With random weights MobileNet-w4a4's activations die out: every code after
its fourth conv quantizes to 0.  QONNX's zoo keeps them live by scaling each
``Quant``-weighted conv's float weights and weight scale by one power of two
chosen from the fan-in, ``k = 2^round(log2(2 / (0.07 * sqrt(fan_in))))``
(0.07 is the zoo's dequantized weight spread).  The integer weights and the
widths are unchanged and every scale stays dyadic.  The benchmark applies it
to the arrays it hands to both the program and the reference.
"""
from __future__ import annotations

import math


def conv_gain(fan_in: int) -> float:
    return 2.0 ** round(math.log2(2.0 / (0.07 * math.sqrt(fan_in))))
