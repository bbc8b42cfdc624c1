"""int8 probe on the card: does the int8 path pay for res5's convs?

    python -m vltk_tpu_torch.tools.probe_int8 [--rois 2400] [--reps 10] [--device cuda|cpu]

Counterpart of ``tools/probe_int8.py`` (JAX on the TPU), which asked
whether XLA maps int8 convs to the v5e's int8 rate. This probe asks it of
the port on the H100: the res5 bottleneck conv stack (1x1 1024->512, 3x3
dilation 2 512->512, 1x1 512->2048) at ``--rois`` RoIs of 14x14 (the
extraction step's ``roi_chunk``), bf16 NHWC activations drawn with numpy
``default_rng(0)`` x 0.05 and chained through the bf16 convs, weights x
0.05. For each conv it times (CUDA events over ``--reps`` calls queued
while the card sleeps, after two warm-up calls):

* ``bf16``: the float layer's conv (``ConvNorm`` without its norm, bf16);
* ``int8``: the same layer on the int8 path with a static scale
  (``ConvNorm(int8=True)``, calibrated on this input), and its three
  parts apart: ``quantize`` (the activation to int8), ``product``
  (``ops.int8.int8_conv2d``: im2col where needed and ``torch._int_mm``)
  and ``rescale`` (int32 -> float32 x scales -> bf16);

beside each product's bound (its operations over the dense int8 and bf16
tensor-core peaks, 1979 TOP/s and 989 TFLOP/s), each path's peak memory,
and whether the card's product equals the exact route bitwise. The last
line is one JSON object with every row. ``--device cpu`` runs the CPU
routes and times them on the host clock (use a few RoIs there).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from vltk_tpu_torch.models.layers import ConvNorm, _hwio_int8, calibrate_int8_scales
from vltk_tpu_torch.ops import int8 as q8
from vltk_tpu_torch.tools.variants import queued_ms

#: (label, in channels, out channels, kernel, dilation and padding)
CONVS = (("1x1 1024->512", 1024, 512, 1, 1), ("3x3 d2 512->512", 512, 512, 3, 2), ("1x1 512->2048", 512, 2048, 1, 1))
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12


def timer(device: torch.device, reps: int) -> Callable[[Callable], float]:
    if device.type == "cuda":
        return lambda fn: queued_ms(fn, reps)

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return host_ms


def peak_gb(fn, device: torch.device):
    """Peak device memory of one call above what was allocated before it
    (None on the CPU)."""
    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def layers(cin: int, cout: int, k: int, d: int, device, gen: np.random.Generator):
    """The bf16 and the int8 conv layer of one res5 conv, on the same
    weights."""
    w = torch.from_numpy(gen.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.05)
    out = []
    for int8 in (False, True):
        m = ConvNorm(cin, cout, k, padding=d if k > 1 else 0, dilation=d, norm=False,
                     dtype=torch.bfloat16, int8=int8).eval()
        with torch.no_grad():
            m.weight.copy_(w)
        out.append(m.to(device))
    return out


@torch.inference_mode()
def run(device: torch.device, rois: int, reps: int) -> Dict:
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.standard_normal((rois, 14, 14, 1024)).astype(np.float32) * 0.05).to(device)
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view of NHWC memory, as the trunk hands it
    ms = timer(device, reps)
    rows = []
    for label, cin, cout, k, d in CONVS:
        plain, int8 = layers(cin, cout, k, d, device, gen)
        calibrate_int8_scales(int8, [(x,)])
        nhwc = x.permute(0, 2, 3, 1)
        x_q, s_x = int8._quantize_input(nhwc)
        w_q, s_w = _hwio_int8(int8.weight)
        product = lambda: q8.int8_conv2d(x_q, w_q, 1, int8.padding, d)  # noqa: E731
        y = product()
        exact = q8.int8_conv2d(x_q, w_q, 1, int8.padding, d, matmul=q8.int8_matmul_exact)
        m_rows, kdim = y.shape[0] * y.shape[1] * y.shape[2], k * k * cin
        ops = 2.0 * m_rows * kdim * cout
        row = {
            "conv": label, "m": m_rows, "k": kdim, "n": cout,
            "bf16_ms": ms(lambda: plain._conv(x)),
            "int8_ms": ms(lambda: int8._int8_conv(x)),
            "quantize_ms": ms(lambda: int8._quantize_input(nhwc)),
            "product_ms": ms(product),
            "rescale_ms": ms(lambda: q8.rescale(y, s_x, s_w, None, torch.bfloat16)),
            "product_bound_ms": ops / INT8_OPS_PER_S * 1e3,
            "bf16_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "bf16_peak_gb": peak_gb(lambda: plain._conv(x), device),
            "int8_peak_gb": peak_gb(lambda: int8._int8_conv(x), device),
            "int8_equals_exact": bool(torch.equal(y, exact)),
        }
        rows.append(row)
        print(f"{label:18s} M={m_rows} K={kdim} N={cout}: bf16 {row['bf16_ms']:.3f} ms; int8 {row['int8_ms']:.3f} ms "
              f"= quantize {row['quantize_ms']:.3f} + product {row['product_ms']:.3f} + rescale "
              f"{row['rescale_ms']:.3f}; bounds int8 {row['product_bound_ms']:.3f} / bf16 {row['bf16_bound_ms']:.3f} ms; "
              f"peak bf16 {row['bf16_peak_gb']} / int8 {row['int8_peak_gb']} GB; product == exact "
              f"{row['int8_equals_exact']}")
        x = plain._conv(x)  # the next conv reads this one's bf16 output
        del exact, y, x_q
    total = {key: sum(r[key] for r in rows) for key in
             ("bf16_ms", "int8_ms", "quantize_ms", "product_ms", "rescale_ms", "product_bound_ms", "bf16_bound_ms")}
    print(f"stack: bf16 {total['bf16_ms']:.3f} ms, int8 {total['int8_ms']:.3f} ms "
          f"(x{total['bf16_ms'] / total['int8_ms']:.2f} of bf16's speed)")
    return {"convs": rows, "stack": total}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rois", type=int, default=2400, help="RoIs of 14x14 (the extraction step's roi_chunk)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("probe_int8: needs a CUDA device (or --device cpu)")
        from vltk_tpu_torch.tools.variants import card_name

        card = card_name()
        print(card)
    out = run(device, args.rois, args.reps)
    print(json.dumps({"card": card, "device": device.type, "rois": args.rois, **out}))


if __name__ == "__main__":
    main()
