"""The benchmark's plain reference and its counts, against the port's CPU
oracle and QONNX's Table III (CPU).  Every configuration ``BENCHMARK.json``
lists is checked, each against the reference file it names, at its
``cpu_image_shape``.  This test may import the port; the reference itself
may not."""
import numpy as np
import pytest
import torch

from bench import check, counts, manifest, model, seeded

BM = manifest.load()
CONFIGS = {c["name"]: manifest.load_config(BM, c["name"])
           for c in BM["configs"]}
SEEDS = (0, 7, 2**31 + 11)


def small(name):
    """The configuration at the image size its CPU tests run it at."""
    return dict(CONFIGS[name], image_shape=CONFIGS[name]["cpu_image_shape"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_equals_the_port_oracle(name, seed):
    from repro_torch.core.executor import execute
    cfg = small(name)
    params = seeded.draw_params(cfg, seed)
    x = seeded.draw_images(cfg, seed, 3)
    g = model.build_graph(cfg, params)
    oracle = execute(g, {"x": x}, device="cpu")[g.output_names[0]]
    got = check.reference(cfg).forward(cfg["layers"], params,
                                       torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(oracle, np.float64),
                                  got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_last_quantized_activation_is_live(name, seed):
    cfg = small(name)
    params = seeded.draw_params(cfg, seed)
    x = torch.from_numpy(seeded.draw_images(cfg, seed, 4))
    codes = check.reference(cfg).last_codes(cfg["layers"], params, x)
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
    forward = check.reference(cfg).forward
    exact = forward(cfg["layers"], params, x).numpy()
    low = forward(cfg["layers"], params, x, dtype=torch.bfloat16)
    err = check.logit_rel_err(low.to(torch.float64).numpy(), exact)
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
