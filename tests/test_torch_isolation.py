"""The port stands alone: importing it (every module) never imports JAX,
and no source file under ``src/repro_torch`` imports JAX or the reference
package."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_port_module_leaves_jax_out():
    mods = _modules()
    assert "repro_torch.kernels.quant_matmul" in mods
    # the LM serving slice: B7, the models, the recipes, serving, launcher
    assert {"repro_torch.kernels.flash_attention", "repro_torch.core.ste",
            "repro_torch.quantize.config", "repro_torch.quantize.layers",
            "repro_torch.models.common", "repro_torch.models.transformer",
            "repro_torch.models.api", "repro_torch.configs.qwen2_1_5b",
            "repro_torch.configs.olmo_1b", "repro_torch.configs.starcoder2_3b",
            "repro_torch.configs.starcoder2_7b", "repro_torch.serve.generation",
            "repro_torch.launch.serve"} <= set(mods)
    # the vlm, moe and audio families: the encoder-decoder and four configs
    assert {"repro_torch.models.encdec", "repro_torch.configs.llava_next_34b",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.whisper_base"} <= set(mods)
    # the ssm and hybrid families: rwkv6, the RG-LRU hybrid and their configs
    assert {"repro_torch.models.rwkv6", "repro_torch.models.rglru",
            "repro_torch.configs.rwkv6_7b", "repro_torch.configs.recurrentgemma_2b"} <= set(mods)
    # the fusion / formats slice: boundary glue, fusion, the paper's formats
    assert {"repro_torch.kernels.quant_pool", "repro_torch.core.lowering.fusion",
            "repro_torch.core.formats", "repro_torch.core.streamline",
            "repro_torch.core.export"} <= set(mods)
    # the serving tier and observability: scheduler, registry, split-merge,
    # tracing, the endpoint, the report, the profiler, fault tolerance
    assert set(SERVING_TIER) <= set(mods)
    # the training path
    assert set(TRAINING) <= set(mods)
    # the launch-geometry autotuner
    assert set(TUNING) <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


SERVING_TIER = ("repro_torch.serve.scheduler", "repro_torch.serve.registry",
                "repro_torch.serve.splitmerge", "repro_torch.obs.trace",
                "repro_torch.obs.http", "repro_torch.obs.report",
                "repro_torch.obs.profile", "repro_torch.dist.fault",
                "repro_torch.launch.serve")


TRAINING = ("repro_torch.optim.schedule", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.dist.collectives",
            "repro_torch.data.pipeline", "repro_torch.ckpt.manager",
            "repro_torch.train.loop", "repro_torch.launch.train",
            "repro_torch.quantize.calibrate")


TUNING = ("repro_torch.tune", "repro_torch.tune.config",
          "repro_torch.tune.roofline", "repro_torch.tune.cache",
          "repro_torch.tune.autotuner")


@pytest.mark.parametrize("module", ["repro_torch.models.encdec",
                                    "repro_torch.configs.whisper_base",
                                    "repro_torch.configs.llava_next_34b",
                                    "repro_torch.serve", "repro_torch.obs",
                                    "repro_torch.dist.fault",
                                    "repro_torch.launch.serve",
                                    "repro_torch.launch.train",
                                    "repro_torch.tune"])
def test_serving_tier_imports_leave_jax_and_the_reference_out(module):
    """Each entry of the serving tier, and the training launcher (which
    imports the whole training path), alone in a fresh interpreter."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    offenders = [str(p.relative_to(SRC)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    assert not list(PKG.rglob("*.so"))        # nothing built is committed


def test_kernel_sources_are_cuda_cpp_for_sm90a():
    from repro_torch.kernels import _build
    csrc = PKG / "kernels" / "csrc"
    srcs = sorted(p.name for p in csrc.glob("*.cu*"))
    assert srcs == ["flash_attention.cu", "int_epilogue.cuh", "int_staging.cuh",
                    "qdq_round.cuh", "quant_dequant.cu", "quant_grouped_conv.cu",
                    "quant_matmul.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert set(_build.SIGNATURES) == {"qdq_launch", "qmm_launch",
                                      "qmm_i8_launch", "gqmm_launch",
                                      "dw_launch", "fa_launch"}
    for name in _build.SIGNATURES:          # each entry point is defined
        assert any(f'extern "C" int {name}(' in p.read_text()
                   for p in csrc.glob("*.cu"))


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a shared ``.cuh`` header must change the library's name,
    or a stale build would be loaded."""
    from repro_torch.kernels import _build
    for p in (PKG / "kernels" / "csrc").glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    hdr = tmp_path / "qdq_round.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build._digest() != before
