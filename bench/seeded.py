"""Everything a run draws from ``--seed``: the weights and the image pool.

The same seed gives the same arrays on every machine (numpy's PCG64 from
``default_rng``), so the CPU tests see the weights the card serves.  Each
is drawn in one call on the host: the program takes its weights as numpy
initializers (``GraphBuilder``) and packs them itself at compile time, and
the draw takes a fraction of a second.  The arrays are handed unchanged to
the program and to the reference.
"""
from __future__ import annotations

import numpy as np

from bench.reference.gain import conv_gain

# streams of one seed: weights and images never share draws
_WEIGHTS, _IMAGES, _TRAFFIC, _SAMPLE = 0, 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one stream; any whole number is a seed."""
    return np.random.default_rng([stream, seed % (1 << 64)])


def weighted_layers(cfg: dict) -> list:
    return [l for l in cfg["layers"] if l["op"] in ("conv", "matmul")]


def weight_shape(layer: dict) -> tuple:
    if layer["op"] == "conv":
        return (layer["cout"], layer["cin"] // layer["group"],
                layer["k"], layer["k"])
    return (layer["cin"], layer["cout"])


def draw_params(cfg: dict, seed: int) -> list:
    """One ``{"w", "scale"}`` per weighted layer: float32 weights (standard
    normal times ``w_std``) and the zoo's dyadic weight scale
    ``0.125 / 2^(bits-1)``, both times the conv gain where the
    configuration asks for it."""
    layers = weighted_layers(cfg)
    shapes = [weight_shape(l) for l in layers]
    flat = rng(seed, _WEIGHTS).standard_normal(
        sum(int(np.prod(s)) for s in shapes), dtype=np.float32)
    params, at = [], 0
    for layer, shape in zip(layers, shapes):
        n = int(np.prod(shape))
        w = flat[at:at + n].reshape(shape) * np.float32(layer["w_std"])
        at += n
        bits = layer["w_bits"]
        scale = 0.125 if bits == 1 else 0.125 / 2 ** (bits - 1)
        if cfg["conv_gain"] and layer["op"] == "conv" and bits > 1:
            k = conv_gain(int(np.prod(shape[1:])))
            w, scale = w * np.float32(k), scale * k
        params.append({"w": np.ascontiguousarray(w, np.float32),
                       "scale": float(np.float32(scale))})
    return params


def draw_images(cfg: dict, seed: int, n: int) -> np.ndarray:
    """``n`` distinct float32 images of the configuration's shape."""
    shape = (n, *cfg["image_shape"])
    x = rng(seed, _IMAGES).standard_normal(int(np.prod(shape)),
                                           dtype=np.float32)
    return (x * np.float32(cfg["image_std"])).reshape(shape)


def traffic_rng(seed: int) -> np.random.Generator:
    return rng(seed, _TRAFFIC)


def sample_rng(seed: int) -> np.random.Generator:
    """Which served rows the comparison takes."""
    return rng(seed, _SAMPLE)
