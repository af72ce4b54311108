"""The benchmark's plain reference and its counts, against the port's CPU
oracle and QONNX's Table III (CPU).  This test may import the port; the
reference itself may not."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import counts, model, seeded
from bench.reference import forward as ref

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {n: json.loads((ROOT / f"bench/configs/{n}.json").read_text())
           for n in ("mobilenet-w4a4", "cnv-w2a2")}
# the image size the CPU tests run each configuration at: MobileNet's
# strides leave 1 x 1 at 32; CNV's unpadded convs need its 32 x 32
SMALL = {"mobilenet-w4a4": 32, "cnv-w2a2": 32}
SEEDS = (0, 7, 2**31 + 11)


def small(name):
    img = SMALL[name]
    return dict(CONFIGS[name], image_shape=[3, img, img])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_equals_the_port_oracle(name, seed):
    from repro_torch.core.executor import execute
    cfg = small(name)
    params = seeded.draw_params(cfg, seed)
    x = seeded.draw_images(cfg, seed, 3)
    g = model.build_graph(cfg, params)
    oracle = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    got = ref.forward(cfg["layers"], params, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(oracle, np.float64),
                                  got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_last_quantized_activation_is_live(name, seed):
    cfg = small(name)
    params = seeded.draw_params(cfg, seed)
    x = torch.from_numpy(seeded.draw_images(cfg, seed, 4))
    codes = ref.last_codes(cfg["layers"], params, x)
    assert torch.equal(codes, torch.round(codes))
    # nonzero codes in every image, so no comparison is of zeros
    assert bool((codes.reshape(4, -1) != 0).any(dim=1).all())
    assert float((codes != 0).double().mean()) > 0.1


@pytest.mark.parametrize("seed", (3, 4, 5))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bfloat16_control_fails_the_limit(name, seed):
    """The control, the reference in the precision below the
    configuration's float32, has to come out as not correct."""
    cfg = small(name)
    params = seeded.draw_params(cfg, seed)
    x = torch.from_numpy(seeded.draw_images(cfg, seed, 8))
    exact = ref.forward(cfg["layers"], params, x).numpy()
    low = ref.forward(cfg["layers"], params, x, dtype=torch.bfloat16)
    from bench.check import logit_rel_err
    err = logit_rel_err(low.to(torch.float64).numpy(), exact)
    assert err > 10 * cfg["check"]["logit_rel_err_limit"]


def test_layer_tables_are_the_zoo_models():
    from repro_torch.models import zoo
    mob = [l for l in CONFIGS["mobilenet-w4a4"]["layers"] if l["op"] == "conv"]
    assert len(mob) == len(zoo.MOBILENET_V1)
    for l, (kind, cin, cout, stride) in zip(mob, zoo.MOBILENET_V1):
        assert (l["cin"], l["cout"], l["stride"]) == (cin, cout, stride)
        assert l["group"] == (cin if kind == "dw" else 1)
        assert l["k"] == (1 if kind == "pw" else 3)
    cnv = CONFIGS["cnv-w2a2"]["layers"]
    convs = [(l["cin"], l["cout"]) if l["op"] == "conv" else "M"
             for l in cnv if l["op"] in ("conv", "maxpool")]
    assert convs == zoo.CNV_CONVS
    assert [(l["cin"], l["cout"]) for l in cnv if l["op"] == "matmul"] == \
        zoo.CNV_FCS


def test_counts_reproduce_table_iii():
    from repro_torch.models import zoo
    cnv, mob = CONFIGS["cnv-w2a2"], CONFIGS["mobilenet-w4a4"]
    macs, weights, bits = zoo.TABLE3["CNV-w2a2"]
    assert counts.macs(cnv, skip_first_conv=True) == macs
    assert sum(n for n, _ in counts.weight_counts(cnv)) == weights
    assert counts.weight_bits(cnv) == bits
    assert counts.macs(cnv) == 59_461_376
    macs, weights, bits = zoo.TABLE3["MobileNet-w4a4"]
    # the repo's own MobileNet check: Table III counts MACs by another
    # convention, within 2e-3; its weights leave out the first conv
    assert abs(counts.macs(mob, skip_first_conv=True) - macs) / macs < 2e-3
    assert sum(n for n, _ in counts.weight_counts(mob)[1:]) == weights
    assert counts.weight_bits(mob) == bits
    assert counts.macs(mob) == 568_740_352
    assert counts.layer_macs(mob)[0] == 10_838_016


def test_counts_match_the_port_cost_report():
    from repro_torch.analysis.cost import infer_cost
    from repro_torch.core import transforms
    for name in sorted(CONFIGS):
        cfg = CONFIGS[name]
        g = transforms.cleanup(model.build_graph(
            cfg, seeded.draw_params(cfg, 0)))
        assert infer_cost(g).macs == counts.macs(cfg)
