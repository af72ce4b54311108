"""The port's multi-process pieces of A16 on the CPU: one spawn of two
``gloo`` ranks (a ``FileStore`` under the test's temporary directory, so
parallel test workers cannot collide), in which

  * ``quantized_psum`` over a mesh axis (and over ``group=``) sums the
    ranks' ``ef_compress`` outputs exactly, and each rank's residual is
    its own;
  * ``to_shardings`` / ``distribute`` over a {data 1, model 2} DeviceMesh
    give qwen2's SMOKE parameters the local shard shapes ``param_pspecs``
    implies, and the same values;
  * ``constrain_logits`` redistributes a replicated DTensor to the spec's
    placements, values unchanged.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

WORLD = 2


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as tsh
    from repro_torch.models import api, common

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    report = {}
    try:
        mesh = tsh.Mesh(np.array([[torch.device("cpu")] * WORLD], dtype=object),
                        ("data", "model"))
        # quantized_psum: the exact sum of every rank's compressed leaves
        g = torch.Generator().manual_seed(100 + rank)
        x = {"a": torch.randn(7, 5, generator=g), "b": torch.randn(13, generator=g) * 3}
        res = {k: torch.randn(v.shape, generator=g) * 1e-3 for k, v in x.items()}
        comp, own = collectives.ef_compress(x, res)
        with mesh:
            summed, new_res = collectives.quantized_psum(x, "model", res)
        by_group, _ = collectives.quantized_psum(x, residual=res, group=dist.group.WORLD)
        for k in x:
            parts = [torch.empty_like(comp[k]) for _ in range(WORLD)]
            dist.all_gather(parts, comp[k])
            assert torch.equal(parts[rank], comp[k])
            assert torch.equal(summed[k], parts[0] + parts[1]), k
            assert torch.equal(by_group[k], summed[k]), k
            assert torch.equal(new_res[k], own[k]), k
        single, single_res = collectives.quantized_psum(x["a"], residual=res["a"],
                                                        group=dist.group.WORLD)
        assert torch.equal(single, summed["a"]) and torch.equal(single_res, own["a"])
        report["psum"] = True

        # to_shardings / distribute: the local shards param_pspecs implies
        cfg = get_smoke_config("qwen2-1.5b")
        params = api.init_params(0, cfg, "cpu")          # same seed: same tensors
        specs = tsh.param_pspecs(params, mesh)
        shardings = tsh.to_shardings(specs, mesh)
        dts = tsh.distribute(params, shardings)
        n_sharded = 0
        for name, p in params.named_parameters():
            spec = specs[name]
            want = tuple(s // WORLD if e == "model" else s for s, e in zip(p.shape, spec))
            assert tuple(dts[name].to_local().shape) == want, (name, spec)
            assert tuple(dts[name].placements) == shardings[name].placements
            assert torch.equal(dts[name].full_tensor(), p.detach()), name
            n_sharded += "model" in spec
        assert n_sharded > 0
        report["sharded_leaves"] = n_sharded

        # constrain_logits on a DTensor: the spec's placements, same values
        logits = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(7))
        dl = distribute_tensor(logits, mesh.device_mesh(), [Replicate(), Replicate()])
        with mesh:
            out = common.constrain_logits(dl)
            want = tsh.placements(common.logits_spec(tuple(logits.shape)), mesh)
        assert tuple(out.placements) == want and want != (Replicate(), Replicate())
        assert torch.equal(out.full_tensor(), logits)
        report["logits_placements"] = [str(p) for p in out.placements]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def test_gloo_ranks_psum_shard_and_constrain(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=WORLD, join=True)
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]
    for r in reports:
        assert r["psum"] is True and r["sharded_leaves"] > 0
        assert r["logits_placements"] == ["S(0)", "S(2)"]
    assert reports[0]["sharded_leaves"] == reports[1]["sharded_leaves"]
