"""Inference-cost report CLI over the model zoo (or a serialized graph).

    python -m repro_torch.analysis.report --model TFC-w2a2
    python -m repro_torch.analysis.report --all [--quick] [--csv | --json]
    python -m repro_torch.analysis.report --graph path/to/graph.json
    python -m repro_torch.analysis.report --quick --device cpu

Counterpart of ``repro.analysis.report``.  ``--device`` names where each
model's plan is compiled (CUDA by default, like every entry point of the
port; ``cpu`` runs the kernels' plain twins).

Per model: the per-layer cost table (MACs, weight/activation bit widths,
minimal accumulator widths, Eq. 5 BOPs, memory traffic) computed from the
analysis subsystem, plus a Table III comparison when the model has a
reference row.  Each model is also compiled so every kernel-lowered layer
reports its requantization path (``int32`` dyadic multiplier+shift vs the
``fp32`` dequant->round->requant chain) and the report's integer-path
summary is populated.  ``--json`` emits machine-readable per-layer rows
plus the integer-path summary per model.  Exit status 0 iff every
requested report was produced.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import transforms
from ..models import zoo

from .cost import CostReport, compare_table3, infer_cost

# models cheap enough for CI smoke runs (MobileNet-224 shape inference and
# weight-quant evaluation dominate full runs)
QUICK_MODELS = ("TFC-w1a1", "TFC-w2a2", "CNV-w2a2")


def _analyzed(g, device=None):
    """Shape-inferred report graph + the compiled plan for requant meta."""
    from ..core.compile import compile_graph
    plan = compile_graph(g, device=device)
    gs = transforms.infer_shapes(g)
    return infer_cost(gs, plan=plan), plan


def _layer_rows(rep: CostReport) -> list:
    return [{
        "layer": l.name, "op": l.op_type, "macs": l.macs,
        "weights": l.weights, "b_w": l.b_w, "b_a": l.b_a,
        "acc_bits": l.acc_bits, "bops": l.bops, "mem_bytes": l.mem_bytes,
        "groups": l.groups, "requant": l.requant,
        "fp32_ops_eliminated": l.fp32_ops_eliminated,
    } for l in rep.layers]


def _payload(name: str, rep: CostReport, plan) -> dict:
    return {
        "model": name,
        "layers": _layer_rows(rep),
        "totals": {
            "macs": rep.macs, "bops": rep.bops, "weights": rep.weights,
            "total_weight_bits": int(rep.total_weight_bits),
            "mem_bytes": rep.total_mem_bytes,
        },
        "integer_path": {
            "integer_segment_fraction": rep.integer_segment_fraction,
            "fp32_ops_eliminated": rep.fp32_ops_eliminated,
            **plan.requant_stats(),
        },
    }


def report_model(name: str, csv: bool = False, device=None):
    rep, plan = _analyzed(zoo.ZOO[name](), device)
    if csv:
        return rep.csv(), rep, plan
    out = [f"== {name} ==", rep.table()]
    if name in zoo.TABLE3:
        conv_net = "CNV" in name or "MobileNet" in name
        out.append("Table III check:")
        out.append(compare_table3(
            rep, zoo.TABLE3[name], skip_first_conv=conv_net,
            skip_first_conv_weights="MobileNet" in name))
    return "\n".join(out), rep, plan


def report_graph_file(path: str, csv: bool = False, device=None):
    from ..core import serialize
    g = serialize.load(path)
    rep, plan = _analyzed(g, device)
    text = rep.csv() if csv else f"== {g.name} ==\n{rep.table()}"
    return text, rep, plan, g.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", action="append", default=[],
                    help=f"zoo model name (one of {', '.join(zoo.ZOO)})")
    ap.add_argument("--all", action="store_true", help="every zoo model")
    ap.add_argument("--quick", action="store_true",
                    help=f"restrict --all to {', '.join(QUICK_MODELS)}")
    ap.add_argument("--graph", action="append", default=[],
                    help="path to a serialized QonnxGraph JSON")
    ap.add_argument("--csv", action="store_true", help="CSV per-layer rows")
    ap.add_argument("--json", action="store_true",
                    help="JSON per-layer rows + integer-path summary")
    ap.add_argument("--device", default=None,
                    help="where the plans are compiled (default: cuda)")
    args = ap.parse_args(argv)

    names = list(args.model)
    if args.all:
        names += [n for n in zoo.ZOO if not args.quick or n in QUICK_MODELS]
    elif args.quick and not names and not args.graph:
        names += list(QUICK_MODELS)
    if not names and not args.graph:
        ap.error("nothing to report: pass --model/--all/--graph")

    payloads = []
    for name in names:
        if name not in zoo.ZOO:
            print(f"unknown model {name!r}; known: {', '.join(zoo.ZOO)}",
                  file=sys.stderr)
            return 2
        text, rep, plan = report_model(name, csv=args.csv,
                                        device=args.device)
        if args.json:
            payloads.append(_payload(name, rep, plan))
        else:
            print(text)
            print()
    for path in args.graph:
        text, rep, plan, gname = report_graph_file(path, csv=args.csv,
                                                   device=args.device)
        if args.json:
            payloads.append(_payload(gname, rep, plan))
        else:
            print(text)
            print()
    if args.json:
        print(json.dumps(payloads, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
