"""Training steps over a pool of device batches, cycled.

Set-up builds the entry's training object and drives it through its first
steps (read for the comparison); those steps are the warm-up too. The
window then steps the same object until ``--seconds`` have passed on the
host clock and ends with a synchronise; the rate is every sample stepped
over that whole time. A traced run profiles the last ``trace_seconds`` of
its window, from a synchronise, and keeps the time and the samples of the
part before it.
"""

from __future__ import annotations

import time

from benchmark.devtrace import Trace


def run(ctx, entry):
    import torch

    system = entry.build(ctx)
    ctx.mark("built")
    system.first_steps()
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    trace = Trace(ctx.device) if ctx.trace else None
    trace_from = ctx.seconds - min(float(ctx.traffic.get("trace_seconds", 2.0)), ctx.seconds)
    traced_work, flops = [], 0.0
    i = int(ctx.traffic["reference_steps"])
    steps, untraced = 0, None
    t0 = time.perf_counter()
    ctx.notes["setup_s"] = time.time() - ctx.t_start
    ctx.mark("warm")
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
        if trace is not None and trace.prof is None and elapsed >= trace_from:
            if cuda:
                torch.cuda.synchronize(ctx.device)
            untraced = (time.perf_counter() - t0, steps * system.batch)
            trace.start()
        system.step(i)
        flops += system.flops(i)
        if trace is not None and trace.prof is not None:
            traced_work.append(system.work(i))
        i += 1
        steps += 1
    if cuda:
        torch.cuda.synchronize(ctx.device)
    seconds = time.perf_counter() - t0
    if trace is not None and trace.running:
        trace.stop()
    samples = steps * system.batch
    window = {"kind": "train", "seconds": seconds, "steps": steps, "samples": samples, "attempted": samples,
              "failed": system.failed_steps() * system.batch, "flops": flops, "traced_work": traced_work,
              "traced_items": len(traced_work) * system.batch,
              "untraced_s": untraced[0] if untraced else 0.0, "untraced_items": untraced[1] if untraced else 0,
              "peak_bytes": torch.cuda.max_memory_allocated(ctx.device) if cuda else 0}
    return window, trace, system.check
