"""Requests completed in the window over the slot rows the plan replayed
meanwhile (``CompiledPlan.replay_count`` x ``max_batch``): the share of
each replayed slot that is not padding."""


def read(run):
    replays = run.record.get("replays")
    if "latency_ms" not in run.record or not replays:
        return None
    return 100.0 * run.record["completed"] / (replays * run.cfg["max_batch"])
