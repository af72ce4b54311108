"""The LM families on DTensors over real collectives: one spawn of four
``gloo`` ranks ({data 2, model 2}, a ``FileStore`` under the test's
temporary directory), each holding the same seeded SMOKE parameters
(vectors redrawn, ROADMAP C20), in which

  * every family's W8A8 forward with its parameters and batch placed by
    ``param_pspecs`` / ``batch_pspecs`` equals the one-process port's by
    C18's rule: no entry beyond 5 % of the largest logit (the bound of
    ``torch_lm_parity.assert_logits``' W8A8 rule), and the entries beyond
    1e-5 within one batch row.  A row-parallel product sums its model-axis
    partials in another order than one matmul does, so, as between the
    card and the CPU (C18), an activation code at a rounding tie may flip
    and move its token's logits: qwen2's 4 x 8 batch has one such token,
    3.1 % of the logits, over ``assert_logits``' 1 % share;
  * the causal full-prefix attention of those forwards runs B7's wrapper
    on each rank's shards (its CPU twin here), as on one process;
  * qwen2's prefill and a decode step on DTensors give the one-process
    logits and KV cache (``assert_logits``, ``assert_cache``);
  * one FSDP train step (every matrix of the state also sharded over the
    data axis: SMOKE leaves sit below the rules' FSDP floor) gives the
    one-process loss and gradient within ``tests/test_torch_train.py``'s
    bounds, and the updated parameters; its AdamW update on the DTensor
    shards (the global norm, the clip, the moments) equals the
    one-process update of the same gradients;
  * a step of two microbatches on DTensors, whose microbatch i holds
    each rank's i-th half of its rows (``train.loop.microbatch``), equals
    the one-process step over the same row groups;
  * a planted fault, the activations' amax taken over each rank's local
    shard, breaks the forward's agreement.

The ranks write rank 0's tensors; the rules run here.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

WORLD = 4
ARCHS = ("qwen2-1.5b", "llava-next-34b", "deepseek-moe-16b", "whisper-base", "rwkv6-7b",
         "recurrentgemma-2b")
LR = 3e-4
CLIP = 0.05          # below the SMOKE gradients' norm: the clip acts
B, S = 4, 8


def _model(cfg, seed=0):
    """Seeded SMOKE parameters on the CPU, every vector redrawn from
    N(0, 0.1) (a zero norm weight would make the logits vacuous)."""
    from repro_torch.models import api
    model = api.init_params(seed, cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for p in model.parameters():
        if p.ndim == 1:
            p.data.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def _batch(cfg, B, S, seed=3):
    from repro_torch.models import api
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=g, dtype=torch.int32),
           "labels": torch.randint(1, cfg.vocab, (B, S), generator=g, dtype=torch.int32)}
    out.update(api.frontend_batch(g, cfg, B, "cpu"))
    return out


def _fsdp(spec, shape):
    """``spec`` with a matrix's largest replicated dim that the data axis
    divides sharded over it (FSDP with no size floor)."""
    from repro_torch.dist.sharding import P
    free = [(shape[d], d) for d, e in enumerate(spec) if e is None and shape[d] % 2 == 0]
    if len(shape) < 2 or not free:
        return spec
    entries = list(spec)
    entries[max(free)[1]] = "data"
    return P(*entries)


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding as tsh
    from repro_torch.models import api, transformer
    from repro_torch.quantize import layers
    from repro_torch.quantize.config import QuantRecipe
    from repro_torch.train import loop

    torch.manual_seed(0)
    torch.set_num_threads(1)        # four ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    saved = {}

    def keep(name, t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        if rank == 0:
            saved[name] = t.detach().to(torch.float32).numpy()

    try:
        mesh = tsh.Mesh(np.array([torch.device("cpu")] * WORLD, dtype=object).reshape(2, 2),
                        ("data", "model"))
        recipe = QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0)

        def placed_model(cfg, fsdp=False):
            model = _model(cfg)
            specs = tsh.param_pspecs(model, mesh, fsdp=False)
            if fsdp:
                specs = {k: _fsdp(specs[k], tuple(p.shape)) for k, p in model.named_parameters()}
            return tsh.distribute_model(model, tsh.to_shardings(specs, mesh)), specs

        def placed(tree, specs):
            return tsh.distribute(tree, tsh.to_shardings(specs, mesh))

        # every family's forward, counting B7's calls and the tensors
        # they see
        flash_calls = []

        def counting_flash(q, k, v, **kw):
            flash_calls.append(type(q) is torch.Tensor)
            return real_flash(q, k, v, **kw)
        real_flash, transformer.flash_attention = transformer.flash_attention, counting_flash
        try:
            for arch in ARCHS:
                cfg = get_smoke_config(arch).replace(quant=recipe)
                batch = _batch(cfg, B, S)
                keep(f"{arch}/plain", api.forward(_model(cfg), batch, cfg)[0])
                keep(f"{arch}/plain_flash", torch.tensor(len(flash_calls)))
                flash_calls.clear()
                model, _ = placed_model(cfg)
                with mesh:
                    logits = api.forward(model, placed(batch, tsh.batch_pspecs(batch, mesh)),
                                         cfg)[0]
                keep(f"{arch}/dtensor", logits)
                keep(f"{arch}/dtensor_flash", torch.tensor(
                    [len(flash_calls), all(flash_calls)]))
                flash_calls.clear()
        finally:
            transformer.flash_attention = real_flash

        # qwen2: prefill, then a decode step, against the cache
        cfg = get_smoke_config("qwen2-1.5b").replace(quant=recipe)
        batch = {"tokens": _batch(cfg, B, S)["tokens"]}
        step_tok = _batch(cfg, B, 1, seed=5)["tokens"]
        plain = _model(cfg)
        lg, cache = api.prefill(plain, batch, cfg, 12)
        keep("prefill/plain", lg)
        lg2, cache = api.decode_step(plain, cache, step_tok, 8, cfg)
        keep("decode/plain", lg2)
        for i, c in enumerate(cache):
            keep(f"cache{i}k/plain", c["k"])
            keep(f"cache{i}v/plain", c["v"])
        model, _ = placed_model(cfg)
        with mesh:
            lg, cache = api.prefill(model, placed(batch, tsh.batch_pspecs(batch, mesh)), cfg, 12)
            keep("prefill/dtensor", lg)
            lg2, cache = api.decode_step(model, cache, placed(step_tok, tsh.batch_pspecs(
                step_tok, mesh)), 8, cfg)
        keep("decode/dtensor", lg2)
        for i, c in enumerate(cache):
            keep(f"cache{i}k/dtensor", c["k"])
            keep(f"cache{i}v/dtensor", c["v"])

        # FSDP train steps: one batch whole, and in two microbatches (the
        # one process takes the DTensor's row groups: rows r·2 + i)
        cfg = get_smoke_config("qwen2-1.5b").replace(quant=recipe)
        batch = _batch(cfg, B, S)
        update = loop.adamw_update
        for n in (1, 2):
            order = [r * n + i for i in range(n) for r in range(B // n)]
            for side in ("plain", "dtensor"):
                tag = f"{side}/mb{n}"
                if side == "plain":
                    model = _model(cfg).requires_grad_(True)
                    b = {k: v[order] for k, v in batch.items()}
                else:
                    model, specs = placed_model(cfg, fsdp=True)
                    model.requires_grad_(True)
                    b = placed(batch, tsh.batch_pspecs(batch, mesh))
                named = dict(model.named_parameters())
                opt = loop.adamw_init({k: p.detach() for k, p in named.items()})
                if side == "dtensor":
                    opt = opt._replace(mu=placed(opt.mu, {k: specs[k] for k in opt.mu}),
                                       nu=placed(opt.nu, {k: specs[k] for k in opt.nu}))

                def recording(grads, state, params, **kw):
                    for k, g in grads.items():
                        keep(f"grad/{k}/{tag}", g)
                    if side == "dtensor":
                        # the one-process update of the same gradients
                        whole = lambda d: {k: (v.full_tensor() if isinstance(v, DTensor)
                                               else v).detach().clone() for k, v in d.items()}
                        _, ref, m = update(whole(grads), state._replace(
                            mu=whole(state.mu), nu=whole(state.nu)), whole(params), **kw)
                        keep(f"grad_norm/{tag}/plain_update", m["grad_norm"])
                        for k in ref.mu:
                            keep(f"mu/{k}/{tag}/plain_update", ref.mu[k])
                            keep(f"nu/{k}/{tag}/plain_update", ref.nu[k])
                    out = update(grads, state, params, **kw)
                    keep(f"grad_norm/{tag}", out[2]["grad_norm"])
                    for k in out[1].mu:
                        keep(f"mu/{k}/{tag}", out[1].mu[k])
                        keep(f"nu/{k}/{tag}", out[1].nu[k])
                    return out
                loop.adamw_update = recording
                try:
                    with mesh:
                        state = {"params": model, "opt": opt,
                                 "step": torch.zeros((), dtype=torch.int32)}
                        hyper = loop.TrainHyper(peak_lr=LR, warmup_steps=0,
                                                max_grad_norm=CLIP, microbatches=n)
                        _, metrics = loop.make_train_step(cfg, hyper)(state, b)
                finally:
                    loop.adamw_update = update
                keep(f"loss/{tag}", metrics["loss"])
                for k, p in model.named_parameters():
                    keep(f"new/{k}/{tag}", p)

        # the planted fault: each rank's activations scaled by its own amax
        orig = layers._dynamic_scale

        def local_amax(x, tq, bw, *, channel_axis=None, expert_axis=None):
            if isinstance(x, DTensor) and channel_axis is None and expert_axis is None:
                loc = torch.amax(torch.abs(x.to_local())).to(torch.float32)
                eps = torch.full((), 1e-8, dtype=torch.float32)
                s = torch.maximum(loc, eps) * torch.reciprocal(layers.max_int(
                    tq.signed, tq.narrow, bw))
                return DTensor.from_local(s, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                                          run_check=False)
            return orig(x, tq, bw, channel_axis=channel_axis, expert_axis=expert_axis)

        layers._dynamic_scale = local_amax
        try:
            cfg = get_smoke_config("qwen2-1.5b").replace(quant=recipe)
            batch = _batch(cfg, B, S)
            model, _ = placed_model(cfg)
            with mesh:
                keep("fault/dtensor", api.forward(
                    model, placed(batch, tsh.batch_pspecs(batch, mesh)), cfg)[0])
        finally:
            layers._dynamic_scale = orig
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **saved)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"done": True}, f)


def _carried(got, want):
    """C18's W8A8 rule: none beyond 5 % of the largest logit, at most one
    batch row with entries beyond 1e-5."""
    d = np.abs(got - want)
    assert d.max() <= 0.05 * np.abs(want).max(), d.max()
    beyond = (d > 1e-5 * (1 + np.abs(want))).reshape(d.shape[0], -1).any(1)
    assert beyond.sum() <= 1, beyond.sum()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dtensor_gloo")
    mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD, join=True)
    for r in range(WORLD):
        assert json.loads((tmp / f"rank{r}.json").read_text())["done"]
    return dict(np.load(tmp / "rank0.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_on_dtensors_equals_one_process(ranks, arch):
    got, want = ranks[f"{arch}/dtensor"], ranks[f"{arch}/plain"]
    assert float(np.ptp(want, axis=-1).min()) > 0          # live logits (C20)
    _carried(got, want)


def test_prefill_and_decode_on_dtensors_equal_one_process(ranks):
    from torch_lm_parity import assert_cache, assert_logits
    for what in ("prefill", "decode"):
        assert_logits(ranks[f"{what}/dtensor"], ranks[f"{what}/plain"], "w8a8", "float32")
    n = 0
    while f"cache{n}k/plain" in ranks:
        for kv in "kv":
            assert_cache(ranks[f"cache{n}{kv}/dtensor"], ranks[f"cache{n}{kv}/plain"],
                         "w8a8", "float32")
        n += 1
    assert n >= 2


def test_b7_runs_on_each_ranks_shards(ranks):
    """On DTensors B7's wrapper is called as often as on one process, each
    time on a rank's plain shards: the families with causal full-prefix
    attention call it, rwkv6 (no attention) and recurrentgemma (windowed)
    do not."""
    for arch in ARCHS:
        n_plain = int(ranks[f"{arch}/plain_flash"])
        n, on_shards = ranks[f"{arch}/dtensor_flash"]
        assert (n, on_shards) == (n_plain, 1), arch
        assert (n_plain > 0) == (arch not in ("rwkv6-7b", "recurrentgemma-2b")), arch


def _assert_step_agrees(ranks, n):
    """The DTensor step of ``n`` microbatches against the one process's:
    the loss (the last microbatch's) and the gradient within
    ``tests/test_torch_train.py``'s bounds; the updated parameters at most
    a flipped update sign apart."""
    got_tag, want_tag = f"dtensor/mb{n}", f"plain/mb{n}"
    loss, want = float(ranks[f"loss/{got_tag}"]), float(ranks[f"loss/{want_tag}"])
    assert abs(loss - want) <= 1e-4 * abs(want)
    names = sorted(k[len("grad/"):-len(want_tag) - 1] for k in ranks
                   if k.startswith("grad/") and k.endswith(want_tag))
    got = [ranks[f"grad/{k}/{got_tag}"] for k in names]
    ref = [ranks[f"grad/{k}/{want_tag}"] for k in names]
    whole = np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(got, ref)) /
                    sum((b ** 2).sum() for b in ref))
    worst = max(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                for a, b in zip(got, ref) if np.linalg.norm(b) > 0)
    assert whole <= 0.02 and worst <= 0.05, (whole, worst)
    for k in names:
        a, b = ranks[f"new/{k}/{got_tag}"], ranks[f"new/{k}/{want_tag}"]
        assert np.abs(a - b).max() <= 2 * LR, k        # at most a flipped update sign
    return names


def test_fsdp_train_step_on_dtensors_equals_one_process(ranks):
    assert len(_assert_step_agrees(ranks, 1)) > 10


def test_two_microbatches_on_dtensors_equal_the_one_process_row_groups(ranks):
    _assert_step_agrees(ranks, 2)


@pytest.mark.parametrize("n", (1, 2))
def test_adamw_update_on_dtensor_shards_equals_the_one_process_update(ranks, n):
    """The DTensor step's AdamW update against the one-process update of
    the same (gathered) gradients: the global norm equal to the
    gradients' own, the clip acting, each moment (linear in the clipped
    gradient) equal within 1e-5, and within 1e-6 of its leaf's largest
    entry where a gradient arrives as a pending sum over the ranks (the
    DTensor update reduces it after the clip's product, the gathered copy
    before)."""
    tag = f"dtensor/mb{n}"
    names = sorted(k[len("mu/"):-len(tag) - 1] for k in ranks
                   if k.startswith("mu/") and k.endswith(tag))
    norm = np.sqrt(sum((ranks[f"grad/{k}/{tag}"].astype(np.float64) ** 2).sum()
                       for k in names))
    gn = float(ranks[f"grad_norm/{tag}"])
    assert abs(gn - norm) <= 1e-5 * norm
    assert abs(gn - float(ranks[f"grad_norm/{tag}/plain_update"])) <= 1e-5 * norm
    assert gn > 2 * CLIP
    for k in names:
        for m in ("mu", "nu"):
            want = ranks[f"{m}/{k}/{tag}/plain_update"]
            np.testing.assert_allclose(ranks[f"{m}/{k}/{tag}"], want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{m} {k}")


def test_planted_local_amax_breaks_the_forward(ranks):
    with pytest.raises(AssertionError):
        _carried(ranks["fault/dtensor"], ranks["qwen2-1.5b/plain"])
