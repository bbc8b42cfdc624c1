"""The readings that the limits of ``workloads/<cell>.json`` are set from,
many seeds in one process (the kernels build once):

    python -m benchmark.readings --workload <cell> --seconds 3 --seeds 1,2,3 \\
        [--variant int8 --variant-seeds 4,5,6] [--reference-variant int8 ...]

``--seeds``: sound runs of the program (short windows, the cell's own
sizes). ``--variant``: runs of the program with a control or a planted
fault switched on (``int8``, ``altered``, ``frozen``, ``half_batch``: what
the cell's entry offers). ``--reference-variant`` (training): the
reference put in the program's place, computed with ``quant="fp8"``,
``quant="int8"`` or ``fault="half_batch"``, against the plain reference. One JSON line a run
on standard output and in ``--out``. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--variant-seeds", default="")
    ap.add_argument("--reference-variant", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.run import _caches

    _caches(harness.ROOT)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    vseeds = [int(s) for s in args.variant_seeds.split(",") if s]
    jobs = [(None, s) for s in seeds] + [(v, s) for v in args.variant for s in vseeds]
    out = open(args.out, "a") if args.out else None
    for variant, seed in jobs:
        ctx = harness.cell_context(args.workload, seed, args.seconds, False)
        ctx.device, ctx.variant, ctx.t_start = torch.device("cuda", 0), variant, time.time()
        res = harness.run(ctx)
        _emit(out, {"workload": args.workload, "variant": variant or "program", "seed": seed,
                    "readings": ctx.notes["readings"], "setup_s": ctx.notes["setup_s"],
                    "setup_split": ctx.notes.get("setup_split"),
                    "metrics": res["metrics"], "check_s": ctx.notes["check_s"]})
        harness.free_device(ctx)
    for variant in args.reference_variant:
        entry = harness.load_module("entries", harness.cell_context(args.workload, 0, 1, False).traffic["entry"])
        for seed in vseeds:
            ctx = harness.cell_context(args.workload, seed, args.seconds, False)
            ctx.device = torch.device("cuda", 0)
            t0 = time.time()
            _emit(out, {"workload": args.workload, "variant": "reference_" + variant, "seed": seed,
                        "readings": entry.reference_control(ctx, variant), "seconds": time.time() - t0})
            harness.free_device(ctx)
    if out:
        out.close()
    return 0


def _emit(out, record) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
