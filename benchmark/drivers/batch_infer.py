"""Offline batch inference: a pool of batches made at set-up, cycled, one
batch dispatched ahead of the one being collected.

The window starts at the first dispatch after the warm-up and ends when the
last batch dispatched inside ``--seconds`` (and no sooner than one pass
over the pool) has been collected; the rate is every item collected over
that whole time. A traced run profiles the last ``trace_seconds`` of its
window, from a step boundary, and keeps the time and the items of the part
before it. The outputs of the pool batches that the
seed samples for the comparison are kept as they were last collected.
"""

from __future__ import annotations

import time

from benchmark.devtrace import Trace


def run(ctx, entry):
    import torch

    system = entry.build(ctx)
    ctx.mark("built")
    pool = system.pool
    n = len(pool)
    for i in range(int(ctx.traffic["warmup_batches"])):
        system.collect(system.dispatch(pool[i % n]))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    sample = set(system.sample())
    work = [(system.items(b), system.flops(b)) for b in pool]  # counted once, outside the window
    kept, flops, items, failed, traced_work, traced_items, untraced = {}, 0.0, 0, 0, [], 0, None
    trace = Trace(ctx.device) if ctx.trace else None
    trace_from = ctx.seconds - min(float(ctx.traffic.get("trace_seconds", 2.0)), ctx.seconds)
    t0 = time.perf_counter()
    ctx.notes["setup_s"] = time.time() - ctx.t_start
    ctx.mark("warm")
    i = 0
    state = (0, system.dispatch(pool[0]))
    while state is not None:
        i += 1
        elapsed = time.perf_counter() - t0
        nxt = None
        if elapsed < ctx.seconds or i < n:  # at least one pass over the pool
            if trace is not None and trace.prof is None and elapsed >= trace_from:
                # the profiler starts between dispatches: collect what is in
                # flight first, so its window holds whole steps
                out = system.collect(state[1])
                items, flops, failed = _count(system, work[state[0] % n], out, items, flops, failed)
                if state[0] % n in sample:
                    kept[state[0] % n] = out
                untraced = (time.perf_counter() - t0, items)
                trace.start()
                state = (i, system.dispatch(pool[i % n]))
                traced_work.append(system.work(pool[i % n]))
                traced_items += work[i % n][0]
                continue
            nxt = (i, system.dispatch(pool[i % n]))
            if trace is not None and trace.running:
                traced_work.append(system.work(pool[i % n]))
                traced_items += work[i % n][0]
        out = system.collect(state[1])
        items, flops, failed = _count(system, work[state[0] % n], out, items, flops, failed)
        if state[0] % n in sample:
            kept[state[0] % n] = out
        state = nxt
    seconds = time.perf_counter() - t0
    if trace is not None and trace.running:
        trace.stop()
    window = {"kind": "infer", "seconds": seconds, "items": items, "attempted": items, "failed": failed,
              "flops": flops, "traced_work": traced_work, "traced_items": traced_items,
              "untraced_s": untraced[0] if untraced else 0.0, "untraced_items": untraced[1] if untraced else 0,
              "peak_bytes": torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0}

    def judged():
        missing = sample - set(kept)
        if missing:
            raise RuntimeError(f"sampled pool batches {sorted(missing)} were never collected in the window")
        return system.check(kept)

    return window, trace, judged


def _count(system, work, out, items, flops, failed):
    return items + work[0], flops + work[1], failed + int(system.failed(out))


def sample_batches(ctx, n: int):
    """The pool batches the comparison judges, drawn from the seed."""
    from benchmark.generate import rng

    k = min(int(ctx.traffic["judged_batches"]), n)
    return [int(x) for x in rng(ctx.seed, 9).choice(n, size=k, replace=False)]

