"""The LM launchers over a process group, on the CPU: one spawn of four
``gloo`` ranks ({data 2, model 2}, a ``FileStore`` under the test's
temporary directory), and the launchers themselves under ``torchrun
--nproc-per-node 2``.  The SMOKE matrices sit below the FSDP rule's size
floor, so the ranks lower it to 0: every matrix of the train state is
also sharded over the data axis (``place_train_state``).  The spawn's
rows are 7 tokens long, which the model axis does not divide, so the
launcher's ``shard_activations`` leaves the sequence whole there: a
sequence sharded over "model" under a batch sharded over "data" makes
every flattening matmul a strided shard, and DTensor's planner then
takes several times as long over the first step (torch 2.13, PERF.md
§7).  The torchrun launches shard it (8 tokens over a (1, 2) mesh).  In
the spawn

  * ``launch.train.train_on`` trains qwen2 SMOKE (W8A8, ``compress_grads``)
    from a checkpoint of the carried state written by one process: 2
    steps and a checkpoint, then a second launch resumes and takes 1
    more step.  Each step's loss equals the one-process port's on the
    same global rows (``data.global_batch_at``, the data ranks' host
    streams in data order) within ``tests/test_torch_dtensor_gloo.py``'s
    bound (rel 1e-4), the first also the JAX reference's single-device
    ``make_train_step`` within ``tests/test_torch_train.py``'s (rel 1e-5);
    the final moments, residual and parameters' change from the carried
    state within its gradient bounds (``_assert_state``), which a
    gradient over half the batch breaks;
  * the world-1 checkpoint, restored into the ranks' shards and saved
    again (gathered, rank 0 writing), gives the same arrays bit for bit;
  * rwkv6 SMOKE takes one step under C21's choice: ``w0``, whose stacking
    axis the reference's FSDP shards, is replicated over the data axis;
  * the LM serving path (``launch.serve``'s placement, the engine) gives
    the one-process engine's tokens, and ``_compress_leaf`` /
    ``ef_compress`` on sharded (and pending-sum) leaves the whole leaf's
    result bit for bit;
  * three planted faults, a rank-local amax in ``_compress_leaf``, data
    rank 1 given rank 0's rows and a gradient over half the batch, each
    break their gate.

Under torchrun (two gloo ranks, a (1, 2) mesh) the train launcher writes
a checkpoint that one process resumes, and resumes one that one process
wrote (world 2 -> 1 and 1 -> 2), with the one-process losses; the serve
launcher gives the one-process tokens.  Only rank 0 prints.
"""
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

WORLD = 4
SRC = Path(__file__).resolve().parents[1] / "src"
B, S = 4, 7                      # global rows, tokens per row
TRAIN_FLAGS = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--global-batch",
               str(B), "--seq", str(S), "--compress-grads"]
LOSS_REL = 1e-4                  # tests/test_torch_dtensor_gloo.py's bounds: the loss,
GRAD_WHOLE, GRAD_LEAF = 0.02, 0.05   # the gradient (relative norm, whole and per leaf)
MOMENT_REL = 1e-5                #   and AdamW's moments
REF_REL = 1e-5                   # tests/test_torch_train.py's float32 W8A8 bound
SPAWN_TIMEOUT = 300              # seconds for the whole spawn (~60 s alone)
LR = 3e-4                        # the launcher's default peak
N_REQ, NEW = 4, 4
RWKV6_ROWS = dict(rows=2, seq=4)   # its time loop's DTensor ops grow with the sequence


def _live(model):
    """Every vector parameter redrawn from N(0, 0.1) (a zero norm weight
    would make the logits vacuous, ROADMAP C20)."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def _train_args(steps, ckpt_dir):
    from repro_torch.launch import train as launcher
    args = launcher.parse(TRAIN_FLAGS + ["--steps", str(steps), "--ckpt-every", "3",
                                         "--ckpt-dir", str(ckpt_dir)])
    return (args,) + launcher.build(args)


def _rows(step, cfg, n_hosts=2, host=None, rows=B, seq=S):
    """Global rows at stream step ``step`` (or one host's)."""
    from repro_torch.data.pipeline import SyntheticLMStream, global_batch_at
    kw = dict(vocab=cfg.vocab, global_batch=rows, seq_len=seq, seed=0)
    if host is not None:
        return SyntheticLMStream(n_hosts=n_hosts, host_index=host, **kw).batch_at(step)
    return global_batch_at(step, n_hosts, **kw)


def _grad_leaf():
    """A (16, 8) gradient of dyadic entries (any sum of them is exact)
    and a residual, seeded."""
    g = torch.Generator().manual_seed(11)
    grad = torch.randint(-1000, 1000, (16, 8), generator=g).float() / 64
    return grad, torch.randn(16, 8, generator=g) * 1e-3


def _local_amax_leaf(e):
    """The planted fault: each rank scales by its own shard's amax."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import collectives
    loc = e.to_local().float()
    scale = torch.clamp_min(torch.amax(torch.abs(loc)), 1e-12) * (1.0 / collectives._LEVELS)
    q = torch.clamp(torch.round(loc / scale), -collectives._LEVELS, collectives._LEVELS)
    res = (loc.double() - q.double() * scale.double()).float()
    wrap = lambda t: DTensor.from_local(t, e.device_mesh, list(e.placements), run_check=False)
    return wrap(q * scale), wrap(res)


def _pl(t) -> list:
    """A DTensor's placements as short names: ``Shard0``, ``Replicate``."""
    return [f"{type(p).__name__}{getattr(p, 'dim', '')}" for p in t.placements]


def _serve_cfg():
    from repro_torch.configs import get_smoke_config
    from repro_torch.quantize.config import QuantRecipe
    return get_smoke_config("qwen2-1.5b").replace(
        quant=QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0), shard_activations=True)


def _prompts(cfg) -> list:
    """The serve launcher's seeded prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)) for _ in range(N_REQ)]


def _rwkv6():
    """rwkv6's SMOKE config (float: C21 is a placement, not a recipe) and
    hyper-parameters."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import loop
    return (get_smoke_config("rwkv6-7b"),
            loop.TrainHyper(peak_lr=LR, warmup_steps=1, total_steps=10))


def _serve_part(rank, mesh, info, keep) -> None:
    """Compression on shards (and the local-amax fault), the serve
    launcher's placement and engine, rwkv6's step under C21."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.data.pipeline import place_host_batch, to_device
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as tsh
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serve.generation import left_pad
    from repro_torch.train import loop

    grad, res = _grad_leaf()
    dm = mesh.device_mesh()
    sh = tsh.distribute(grad, tsh.Sharding(dm, (Shard(0), Shard(1)), None))
    rsh = tsh.distribute(res, tsh.Sharding(dm, (Shard(0), Shard(1)), None))
    for tag, fn in (("sound", collectives._compress_leaf), ("fault", _local_amax_leaf)):
        q, r = fn(sh)
        keep(f"compress/{tag}/q", q)
        keep(f"compress/{tag}/res", r)
    pending = DTensor.from_local(grad / WORLD, dm, [Partial(), Partial()], run_check=False)
    q, r = collectives.ef_compress({"w": pending}, {"w": rsh})
    keep("compress/pending/q", q["w"])
    keep("compress/pending/res", r["w"])
    info["pending_placements"] = _pl(r["w"])

    # serving: the launcher's placement and engine, live vectors; and the
    # slot's prefill logits on the same placement
    scfg = _serve_cfg()
    init = api.init_params
    live = lambda *a, **k: _live(init(*a, **k))
    with mock.patch.object(api, "init_params", live), mesh:
        out = serve._serve_lm_on(types.SimpleNamespace(requests=N_REQ, max_new_tokens=NEW),
                                 scfg, mesh, torch.device("cpu"))
        params = live(0, scfg, "cpu")
        tsh.distribute_model(params, tsh.to_shardings(
            tsh.param_pspecs(params, mesh, fsdp=False), mesh))
        toks = left_pad(_prompts(scfg))
        keep("serve/prefill", api.prefill(params, {"tokens": toks}, scfg,
                                          toks.shape[1] + NEW)[0])
    info["tokens"] = [r.tolist() for r in out["results"]]
    info["token_types"] = sorted({type(r).__name__ for r in out["results"]})

    # rwkv6: one step under C21's choice
    rcfg, rhyper = _rwkv6()
    state = loop.init_train_state(0, rcfg, rhyper, "cpu")
    _live(state["params"])
    state = loop.place_train_state(state, mesh)
    info["w0"] = _pl(state["params"].layers[0].w0)
    batch = place_host_batch(to_device(_rows(0, rcfg, host=tsh.data_index(mesh, rank),
                                             **RWKV6_ROWS), "cpu"), mesh)
    with mesh:
        state, m = loop.make_train_step(rcfg, rhyper)(state, batch)
    keep("rwkv6/loss", m["loss"])
    for k, v in _flatten(state).items():
        keep(f"rwkv6/{k}", v)


def _train_part(rank, tmp, mesh, info, keep) -> None:
    """The mesh from the group, the carried checkpoint into the shards and
    out again, the launcher's two launches, the row fault."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import place_host_batch, to_device
    from repro_torch.dist import fault
    from repro_torch.dist import sharding as tsh
    from repro_torch.launch import train as launcher
    from repro_torch.models.common import dtensor_scope
    from repro_torch.train import loop

    info["elastic"] = [fault.elastic_mesh(device="cpu").shape,
                       fault.elastic_mesh(prefer_model=2, device="cpu").shape]
    info["data_index"] = tsh.data_index(mesh, rank)

    # the carried state's checkpoint, written by one process meanwhile,
    # into the shards and out again (gathered; rank 0 writes)
    args, cfg, hyper = _train_args(3, os.path.join(tmp, "train"))
    mgr = CheckpointManager(args.ckpt_dir)
    deadline = time.monotonic() + 300
    while mgr.latest_step() is None:
        if time.monotonic() > deadline:
            raise TimeoutError("no carried checkpoint")
        time.sleep(0.2)
    state = loop.place_train_state(loop.init_train_state(0, cfg, hyper, "cpu"), mesh)
    mgr.restore(1, state)
    CheckpointManager(os.path.join(tmp, "roundtrip")).save(1, state, extra={"step": 0})
    info["placements"] = {k: [v.ndim] + _pl(v) for k, v in state["opt"].mu.items()}

    # the launcher: 2 steps and a checkpoint, then a resumed launch of 1
    info["first"] = launcher.train_on(args, cfg, hyper, mesh)
    args, cfg, hyper = _train_args(4, os.path.join(tmp, "train"))
    info["second"] = launcher.train_on(args, cfg, hyper, mesh)

    # planted fault: data rank 1 given data rank 0's rows (the carried
    # state's first loss)
    host0 = place_host_batch(to_device(_rows(0, cfg, host=0), "cpu"), mesh)
    with mesh, dtensor_scope(state["params"]):
        keep("fault/rows_loss", loop.loss_fn(state["params"], host0, cfg, hyper)[0])


def _flatten(state) -> dict:
    """{checkpoint key: tensor} of a train state's leaves."""
    from repro_torch.ckpt.manager import _flatten as flatten
    return flatten(state)


def _leaves(state) -> dict:
    """A one-process train state as the checkpoint's numpy arrays."""
    return {k: v.detach().numpy().copy() for k, v in _flatten(state).items()}


def _rank_main(rank: int, tmp: str) -> None:
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as tsh
    from repro_torch.launch.mesh import init_distributed

    torch.manual_seed(0)
    torch.set_num_threads(1)        # the ranks share the host's cores
    init_distributed("cpu", rank=rank, world_size=WORLD,
                     store=dist.FileStore(os.path.join(tmp, "store"), WORLD))
    tsh._FSDP_MIN_SIZE = 0          # SMOKE leaves: FSDP on every matrix
    saved, info = {}, {}

    def keep(name, t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        if rank == 0:
            saved[name] = t.detach().to(torch.float32).numpy()

    try:
        mesh = tsh.Mesh(np.array([torch.device("cpu")] * WORLD, dtype=object).reshape(2, 2),
                        ("data", "model"))
        # the serving half first: the train half waits for the carried
        # checkpoint, which this process's JAX reference writes meanwhile
        _serve_part(rank, mesh, info, keep)
        _train_part(rank, tmp, mesh, info, keep)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    if rank == 0:
        np.savez(os.path.join(tmp, "rank0.npz"), **saved)


# ----------------------------------------------------------- one process

def _reference_carried():
    """The reference's SMOKE qwen2 state after one W8A8 step with
    compression (the carried state: moments, residual and counters
    live), as numpy; its jitted step (the launcher's first launch's
    hyper-parameters) and the state itself."""
    import jax
    import jax.numpy as jnp
    import torch_lm_parity as lp
    from repro.configs import get_smoke_config as ref_smoke
    from repro.optim import adamw as ref_adamw
    from repro.optim import compress as ref_compress
    from repro.quantize.config import QuantRecipe as RefRecipe
    from repro.train import loop as ref_loop

    rc = ref_smoke("qwen2-1.5b").replace(quant=RefRecipe.w_a(8.0, 8.0), shard_activations=True,
                                          remat=False)
    hyper = ref_loop.TrainHyper(peak_lr=LR, warmup_steps=1, total_steps=3, compress_grads=True)
    tree = jax.tree.map(jnp.asarray, lp.reference_tree("qwen2-1.5b"))
    state = {"params": tree, "opt": ref_adamw.adamw_init(tree),
             "step": jnp.zeros((), jnp.int32), "compress": ref_compress.compress_init(tree)}
    step = jax.jit(ref_loop.make_train_step(rc, hyper))
    warm = {k: jnp.asarray(np.random.default_rng(5).integers(0, rc.vocab, (B, S)), jnp.int32)
            for k in ("tokens", "labels")}
    state, _ = step(state, warm)
    return jax.tree.map(np.asarray, state), step, state


# float weights and activations: the launcher under torchrun, at half
# the DTensor ops of W8A8
TORCHRUN_TRAIN = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--global-batch", "2",
                  "--seq", "8", "--ckpt-every", "2", "--wbits", "0"]
TORCHRUN_SERVE = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--requests", "4",
                  "--max-new-tokens", "4"]


def _torchrun(module: str, *flags) -> subprocess.Popen:
    """``torchrun --standalone --nproc-per-node 2 -m module flags``,
    started."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", "2", "-m", module, *flags],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _summaries(proc: subprocess.Popen, timeout: float = 300) -> list:
    """The JSON lines a torchrun run printed; it must exit 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything at once: the spawn, two torchrun launches (the
    train launcher resuming a world-1 checkpoint; the serve launcher)
    and, in this process, the JAX reference and the one-process runs."""
    import torch.multiprocessing as mp

    import jax
    import jax.numpy as jnp

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import serve
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop

    tmp = tmp_path_factory.mktemp("launch_gloo")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    ctx = mp.spawn(_rank_main, args=(str(tmp),), nprocs=WORLD, join=False)
    procs, threads = [], torch.get_num_threads()
    torch.set_num_threads(2)        # the spawn and torchrun's ranks need the cores
    try:
        # world 1 writes step 2; torchrun restores it at world 2
        ckpt = lambda d, n: TORCHRUN_TRAIN + ["--steps", str(n), "--ckpt-dir", str(tmp / d)]
        one = {"b2": launcher.main(ckpt("b", 2))}
        procs = [_torchrun("repro_torch.launch.train", *ckpt("b", 3)),
                 _torchrun("repro_torch.launch.serve", *TORCHRUN_SERVE)]
        # the carried state, written as the train spawn's checkpoint
        _, cfg, hyper = _train_args(3, tmp / "train")
        carried, ref_step, ref_state = _reference_carried()
        state = loop.train_state_from_reference(carried, cfg, hyper, "cpu")
        CheckpointManager(tmp / "train").save(1, state, extra={"step": 0, "seed": 0})
        # the JAX reference's first step and the one-process port over the
        # same global rows, launch by launch; and over data rank 0's rows
        # alone (the planted fault of a gradient over half the batch)
        _, m = ref_step(ref_state, jax.tree.map(jnp.asarray, _rows(0, cfg)))
        one.update(ref_loss=float(m["loss"]), carried=_leaves(state))
        one["state"], one["losses"] = _one_process_train(state)
        one["half"], _ = _one_process_train(
            loop.train_state_from_reference(carried, cfg, hyper, "cpu"), host=0)
        one.update(rwkv6=_one_process_rwkv6(), serve=_one_process_serve(),
                   compress=_one_process_compress(),
                   c={n: launcher.main(ckpt("c", n)) for n in (2, 3, 4)},
                   served=serve.main(TORCHRUN_SERVE))
        (b3,) = _summaries(procs[0])
        one["b4"] = launcher.main(ckpt("b", 4))          # world 2 -> 1
        torchrun = {"b3": b3, "served": _summaries(procs[1])}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        torch.set_num_threads(threads)
        _join(ctx, deadline)
    info = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    saved = dict(np.load(tmp / "rank0.npz"))
    return types.SimpleNamespace(tmp=tmp, info=info, saved=saved, one=one, torchrun=torchrun)


def _join(ctx, deadline: float) -> None:
    """Join the spawn by ``deadline`` (a rank stuck in a collective would
    wait out gloo's 30-minute timeout): past it, terminate the ranks and
    fail."""
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"the gloo ranks were not done within {SPAWN_TIMEOUT} s")


def _one_process_train(state, host=None) -> tuple:
    """Steps 2-4 from the carried ``state`` in one process, launch by
    launch as the spawn's launcher takes them, over the global rows (or
    data rank ``host``'s alone); returns the state's leaves and the
    losses by step."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import loop
    losses = {}
    for steps, rows in ((3, (0, 1)), (4, (2,))):
        _, cfg, hyper = _train_args(steps, "unused")
        fn = loop.make_train_step(cfg, hyper)
        for r in rows:
            state, m = fn(state, to_device(_rows(r, cfg, host=host), "cpu"))
            losses[int(state["step"])] = float(m["loss"])
    return _leaves(state), losses


def _one_process_rwkv6():
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import loop
    cfg, hyper = _rwkv6()
    state = loop.init_train_state(0, cfg, hyper, "cpu")
    _live(state["params"])
    init = _leaves(state)
    state, m = loop.make_train_step(cfg, hyper)(state, to_device(_rows(0, cfg, **RWKV6_ROWS),
                                                                  "cpu"))
    return float(m["loss"]), _leaves(state), init


def _one_process_serve():
    """The one-process engine's tokens and the slot's prefill logits."""
    from repro_torch.models import api
    from repro_torch.serve.generation import GenerationEngine, left_pad
    cfg = _serve_cfg()
    params = _live(api.init_params(0, cfg, "cpu"))
    eng = GenerationEngine(params, cfg, max_batch=4)
    reqs = [eng.submit(p, NEW) for p in _prompts(cfg)]
    eng.run_pending()
    toks = left_pad(_prompts(cfg))
    logits, _ = api.prefill(params, {"tokens": toks}, cfg, toks.shape[1] + NEW)
    return [r.result.tolist() for r in reqs], logits.numpy()


def _one_process_compress():
    from repro_torch.dist import collectives
    grad, res = _grad_leaf()
    q, r = collectives._compress_leaf(grad)
    qp, rp = collectives.ef_compress({"w": grad}, {"w": res})
    return {"q": q.numpy(), "res": r.numpy(), "pending/q": qp["w"].numpy(),
            "pending/res": rp["w"].numpy()}


# ----------------------------------------------------------------- gates

def _assert_loss(got: float, want: float, rel: float = LOSS_REL) -> None:
    assert abs(got - want) <= rel * abs(want), (got, want, abs(got / want - 1))


def _assert_state(got: dict, want: dict, carried: dict) -> None:
    """A train state against one process's, both from ``carried``.  AdamW's
    moments, the compression residual and each parameter's change from the
    carried state (``want - carried``: every one a function of the
    gradients) within ``tests/test_torch_dtensor_gloo.py``'s gradient
    bounds, in relative norm: 2 % over a kind's leaves, 5 % in each; every
    moment leaf but at most one also within its moments' 1e-5.  A W8A8
    activation code at a rounding tie may flip on the ranks (C18) and move
    one leaf's gradient (in the spawn, ``layers.0.attn.wv``'s).  Any other
    leaf (the step counters) equal."""
    assert set(got) == set(want)
    kinds = ("params/", "opt/mu/", "opt/nu/", "compress/residual/")
    for kind in kinds:
        keys = [k for k in want if k.startswith(kind)]
        if not keys:
            continue
        diff = {k: np.linalg.norm(got[k].astype(np.float64) - want[k]) for k in keys}
        ref = {k: np.linalg.norm(want[k].astype(np.float64)
                                 - (carried[k] if kind == "params/" else 0)) for k in keys}
        rel = {k: diff[k] / ref[k] if ref[k] else (np.inf if diff[k] else 0.0) for k in keys}
        whole = np.sqrt(sum(d ** 2 for d in diff.values()) / sum(r ** 2 for r in ref.values()))
        assert whole <= GRAD_WHOLE and max(rel.values()) <= GRAD_LEAF, \
            (kind, whole, max(rel.items(), key=lambda kv: kv[1]))
        if kind.startswith("opt/"):
            beyond = sorted(k for k in keys if rel[k] > MOMENT_REL)
            assert len(beyond) <= 1, (kind, beyond)
    for k in want:
        if not k.startswith(kinds):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _ckpt(path: Path, step: int) -> dict:
    with np.load(path / f"step_{step:010d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_mesh_and_data_coordinates_from_the_group(runs):
    """Under the group ``elastic_mesh`` has one entry per rank: (1, 4) by
    default (``prefer_model=16``), (2, 2) with ``prefer_model=2``; ranks
    that differ only in their model coordinate share the data coordinate."""
    assert runs.info[0]["elastic"] == [{"data": 1, "model": 4}, {"data": 2, "model": 2}]
    assert [i["data_index"] for i in runs.info] == [0, 0, 1, 1]


def test_train_launcher_on_the_group_equals_one_process(runs):
    first, second = runs.info[0]["first"], runs.info[0]["second"]
    assert (first["start"], second["start"]) == (1, 3)
    assert first["mesh"] == {"data": 2, "model": 2} and first["world_size"] == WORLD
    got = {int(k): v for d in (first, second) for k, v in d["losses"].items()}
    want = runs.one["losses"]
    assert sorted(got) == sorted(want) == [2, 3, 4]
    for k in want:
        _assert_loss(got[k], want[k])
    # every rank reports the same losses
    for info in runs.info[1:]:
        assert info["first"]["losses"] == first["losses"]
    # the state after step 4, read from the ranks' last checkpoint
    saved = _ckpt(runs.tmp / "train", 4)
    _assert_state(saved, runs.one["state"], runs.one["carried"])
    assert int(saved["step"]) == int(saved["opt/step"]) == 4
    from repro_torch.ckpt import CheckpointManager
    assert CheckpointManager(runs.tmp / "train").all_steps() == [1, 3, 4]


def test_fsdp_and_tensor_parallel_placement(runs):
    """With the floor lowered, AdamW's moments follow their parameters,
    placed as the reference places its stacked leaves: every matrix
    sharded over the data axis (FSDP) and the model axis; a layer's norm
    weight, (L, D) there, over the data axis; a bias over the model axis;
    the final norm replicated."""
    pl = runs.info[0]["placements"]
    assert pl["layers.0.attn.wq"] == [2, "Shard0", "Shard1"]
    assert pl["embed"] == [2, "Shard1", "Shard0"]              # vocab-parallel
    assert pl["layers.0.attn_norm.w"] == [1, "Shard0", "Replicate"]
    assert pl["layers.0.attn.bq"] == [1, "Replicate", "Shard0"]
    assert pl["final_norm.w"] == [1, "Replicate", "Replicate"]
    for k, (ndim, data, _) in pl.items():
        assert ndim == 1 or data.startswith("Shard"), k


def test_first_step_loss_equals_the_jax_reference(runs):
    got = runs.info[0]["first"]["losses"]["2"]
    _assert_loss(got, runs.one["ref_loss"], REF_REL)
    _assert_loss(runs.one["losses"][2], runs.one["ref_loss"], REF_REL)


def test_checkpoint_restored_into_shards_and_gathered_again_is_bit_identical(runs):
    a, b = _ckpt(runs.tmp / "train", 1), _ckpt(runs.tmp / "roundtrip", 1)
    assert set(a) == set(b) and len(a) > 20
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_rwkv6_step_under_the_c21_choice(runs):
    """C21: the reference's FSDP shards ``w0``'s stacking axis; the port
    replicates the leaf over the data axis (its model-axis shard kept),
    and the step equals one process's, ``u_bonus`` too: shared by every
    batch row, its gradient is a pending sum over the data axis (C24)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding as tsh
    from repro_torch.models import api
    cfg = get_smoke_config("rwkv6-7b")
    mesh = tsh.Mesh(np.array([torch.device("meta")] * 4, dtype=object).reshape(2, 2),
                    ("data", "model"))
    _, shape, stacked = api.reference_layout(cfg)["layers.0.w0"]
    with mock.patch.object(tsh, "_FSDP_MIN_SIZE", 0):
        assert stacked and tsh._rule("w0", shape, mesh, True, {}, ()) == tsh.P("data", "model")
        port = tsh.param_pspecs({"layers.0.w0": shape[1:]}, mesh,
                                layout=api.reference_layout(cfg))
    assert port["layers.0.w0"] == tsh.P("model")
    assert runs.info[0]["w0"] == ["Replicate", "Shard0"]
    loss, state, init = runs.one["rwkv6"]
    _assert_loss(float(runs.saved["rwkv6/loss"]), loss)
    _assert_state({k: runs.saved[f"rwkv6/{k}"] for k in state}, state, init)


def _carried(got, want) -> np.ndarray:
    """C18's W8A8 rule (``tests/test_torch_dtensor_gloo.py``): no entry
    beyond 5 % of the largest logit, at most one batch row with entries
    beyond 1e-5; returns which rows moved."""
    d = np.abs(got - want)
    assert d.max() <= 0.05 * np.abs(want).max(), d.max()
    beyond = (d > 1e-5 * (1 + np.abs(want))).reshape(d.shape[0], -1).any(1)
    assert beyond.sum() <= 1, beyond.sum()
    return beyond


def test_served_tokens_equal_the_one_process_engine(runs):
    """Every rank serves the same slot and takes the same tokens, whole
    and on the host.  The slot's prefill logits on the ranks' shards hold
    C18's rule against one process's; the tokens equal the one-process
    engine's but in a request whose prefill row that rule let move (none
    moved in this run)."""
    want, logits = runs.one["serve"]
    assert float(np.ptp(logits, axis=-1).min()) > 0          # live logits (C20)
    moved = _carried(runs.saved["serve/prefill"], logits)
    for info in runs.info:
        assert info["token_types"] == ["Tensor"] and len(info["tokens"]) == N_REQ
        for j, (got, ref) in enumerate(zip(info["tokens"], want)):
            assert got == ref or moved[j], j


@pytest.mark.parametrize("what", ["", "pending/"])
def test_compress_leaf_on_shards_equals_the_whole_leaf(runs, what):
    """``_compress_leaf`` on a leaf sharded over both axes, and
    ``ef_compress`` of a pending sum over the ranks against a sharded
    residual (redistributed to the residual's placement), equal the
    whole leaf's bit for bit."""
    tag = "sound/" if not what else what
    for part in ("q", "res"):
        np.testing.assert_array_equal(runs.saved[f"compress/{tag}{part}"],
                                      runs.one["compress"][f"{what}{part}"])
    assert runs.info[0]["pending_placements"] == ["Shard0", "Shard1"]


@pytest.mark.parametrize("fault", ["rank-local amax", "rank 1 given rank 0's rows",
                                   "a gradient over half the batch"])
def test_planted_faults_break_their_gates(runs, fault):
    with pytest.raises(AssertionError):
        if fault == "rank-local amax":
            np.testing.assert_array_equal(runs.saved["compress/fault/q"],
                                          runs.one["compress"]["q"])
        elif fault == "rank 1 given rank 0's rows":
            _assert_loss(float(runs.saved["fault/rows_loss"]), runs.one["losses"][2])
        else:
            _assert_state(_ckpt(runs.tmp / "train", 4), runs.one["half"], runs.one["carried"])


# -------------------------------------------------------------- torchrun

def test_launchers_under_torchrun(runs):
    """Two gloo ranks, a (1, 2) mesh: each launcher prints one summary,
    rank 0's.  The train launcher resumes a checkpoint one process wrote
    at step 2 (world 1 -> 2) and writes step 3, which one process resumes
    for step 4 (world 2 -> 1); the losses and the state after step 4 equal
    the uninterrupted one-process launches' (``--steps`` 2, 3, 4, as the
    schedule's total follows ``--steps``).  The serve launcher's tokens
    are the one-process launcher's."""
    b2, b3, b4, c = (runs.one["b2"], runs.torchrun["b3"], runs.one["b4"], runs.one["c"])
    assert b3["mesh"] == {"data": 1, "model": 2} and b3["rank"] == 0
    assert (b2["world_size"], b3["world_size"], b4["world_size"]) == (1, 2, 1)
    assert (b3["start"], b4["start"]) == (2, 3)
    _assert_loss(b3["losses"]["3"], c[3]["losses"][3])
    _assert_loss(b4["losses"][4], c[4]["losses"][4])
    carried, again = _ckpt(runs.tmp / "b", 2), _ckpt(runs.tmp / "c", 2)
    for k in carried:
        np.testing.assert_array_equal(carried[k], again[k], err_msg=k)
    _assert_state(_ckpt(runs.tmp / "b", 4), _ckpt(runs.tmp / "c", 4), carried)
    (served,) = runs.torchrun["served"]
    assert served["mesh"] == {"data": 1, "model": 2} and served["requests"] == 4
    assert served["results"] == [r.tolist() for r in runs.one["served"]["results"]]


def test_several_entries_without_a_group_name_torchrun():
    from repro_torch.dist import sharding as tsh
    from repro_torch.launch import mesh as lmesh
    mesh = tsh.Mesh(np.array([torch.device("cpu")] * 2, dtype=object).reshape(1, 2),
                    ("data", "model"))
    with pytest.raises(RuntimeError, match="torchrun"):
        lmesh.mesh_rank(mesh)
    assert lmesh.mesh_rank(tsh.Mesh(np.array([[torch.device("cpu")]], dtype=object),
                                    ("data", "model"))) == 0
    from repro_torch.launch import train as launcher
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.train_on(*_train_args(1, "unused"), mesh)
    with mock.patch.dict(os.environ, {"RANK": "0"}, clear=True):
        with lmesh.torchrun_group("cpu") as rank:
            assert rank == 0 and not torch.distributed.is_initialized()


def test_global_batch_is_the_host_streams_in_data_order():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLMStream
    cfg = get_smoke_config("qwen2-1.5b")
    whole = _rows(3, cfg, n_hosts=2)
    for h in range(2):
        part = SyntheticLMStream(vocab=cfg.vocab, global_batch=B, seq_len=S, seed=0,
                                 n_hosts=2, host_index=h).batch_at(3)
        for k in whole:
            np.testing.assert_array_equal(whole[k][h * B // 2:(h + 1) * B // 2], part[k])

