"""Epoch times of ``chip_smoke.py``'s training phases in two checkouts, on
one card, alternated.

    python -m vltk_tpu_torch.tools.ab_train_phases --a DIR --b DIR [--order abba] [--out FILE]

Each letter of ``--order`` is one fresh process in that checkout (its own
``chip_smoke.py``, its own ``vltk_tpu_torch``, its own kernel builds) that
runs the phases whose trainers go through ``SimpleExperiment``'s device
feed: ``phase_training`` (OCRTokenExperiment, LayoutLM-base, 8 steps),
``phase_span_training`` (DocVQASpanExperiment, 8 steps) and
``phase_lxmert_train`` (LxmertVQAExperiment and LxmertPretrainExperiment,
LXMERT-base, 4 steps each). It prints one JSON line a run: the epoch's
wall time (``train_s``: ``exp()`` to a synchronise, the end-of-epoch
checkpoint included) and the bare step on one device-resident batch
(``step_ms``) of each trainer, with the card's name and power limit; then
the median of each over the runs of each checkout. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

_CHILD = r"""
import json, subprocess, sys, torch
import chip_smoke as cs
from vltk_tpu_torch import ops
from vltk_tpu_torch.ops import _build

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
_build.build(["flash_attention", "flash_attention_bwd"])
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
res = {"card": smi}
ocr = cs.phase_training(dev, ops.KERNEL_WRAPPERS, smi)
res["ocr"] = {"train_s": ocr["train_s"], "step_ms": ocr["timed"]["auto"]["step_ms"]}
span = cs.phase_span_training(dev, ops.KERNEL_WRAPPERS, smi)
res["span"] = {"train_s": span["train_s"], "step_ms": span["timed"]["step_ms"]}
lx = cs.phase_lxmert_train(dev, ops.KERNEL_WRAPPERS, smi)
for name in ("vqa", "pretrain"):
    res["lxmert_" + name] = {"train_s": lx[name]["train_s"], "step_ms": lx[name]["step_ms"]}
print("AB_RESULT " + json.dumps(res), flush=True)
"""


def run_one(checkout: str, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout, env=env, capture_output=True, text=True,
                          timeout=timeout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"run in {checkout} exited {proc.returncode}:\n{proc.stdout[-4000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("AB_RESULT ")]
    if len(lines) != 1:
        raise RuntimeError(f"run in {checkout} printed no result:\n{proc.stdout[-4000:]}")
    return json.loads(lines[0][len("AB_RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="the first checkout (e.g. the parent commit, unpacked)")
    ap.add_argument("--b", required=True, help="the second checkout")
    ap.add_argument("--order", default="abba", help="one process a letter, in this order")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a process may take")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    dirs = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    if set(args.order) - set(dirs):
        ap.error("--order takes the letters a and b")
    lines, runs = [], {"a": [], "b": []}
    for i, letter in enumerate(args.order):
        res = run_one(dirs[letter], args.timeout)
        runs[letter].append(res)
        lines.append(json.dumps({"run": i, "checkout": letter, "dir": dirs[letter], **res}))
        print(lines[-1], flush=True)
    summary = {}
    for letter, rs in runs.items():
        if rs:
            summary[letter] = {t: {m: float(np.median([r[t][m] for r in rs])) for m in ("train_s", "step_ms")}
                               for t in rs[0] if t != "card"}
    lines.append(json.dumps({"median": summary}))
    print(lines[-1])
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
