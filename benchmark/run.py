"""Run one cell of the benchmark once, on one CUDA device.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and the result as the last line of standard output: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last.
Exits non-zero, printing no result, without a CUDA device, when a module
of JAX or of the JAX package is loaded after the window, or when the
program is not there.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# libraries the program may use must not load JAX or TensorFlow themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_JAX", "0")


def _caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout, so only a cell's
    first run there compiles. (The program's own nvcc and g++ builds go to
    its fixed ``_build`` directories inside the checkout.)"""
    base = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    _caches(harness.ROOT)
    import torch

    ctx = harness.cell_context(args.workload, args.seed, args.seconds, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(ctx.cell["chips"]):
        print(f"benchmark: cell {args.workload} needs {ctx.cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    ctx.device = torch.device("cuda", 0)
    ctx.t_start = T_START
    torch.cuda.init()
    ctx.mark("imports")
    result = harness.run(ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"benchmark: {args.workload} seed {args.seed}: reference check {ctx.notes['check_s']:.1f} s; "
          f"readings {json.dumps(ctx.notes['readings'])}; set-up split {json.dumps(ctx.notes['setup_split'])}",
          file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
