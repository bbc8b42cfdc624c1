"""Self-attention with segment ids, in plain PyTorch.

Counterpart of ``vltk_tpu/models/lxmert.py:_flash_self_attention``, which
wraps the Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.
flash_attention``; this is the plain version the CPU tests hold against
it, and the one ``chip_smoke.py`` holds the CUDA kernel
``csrc/flash_attention.cu`` against. Same signature and layout: q, k, v
(n, s, nh, dh), mask (n, s) (1 real, 0 pad) or None.

What the JAX function does, step for step:

* pads s up to a multiple of 128 with zeros (q, k, v and the mask), after
  synthesising an all-ones mask when ``mask`` is None and s needs padding;
* uses segment ids q = kv = mask as int32, so a query sees only the keys
  with its own id: a pad query sees the pad keys, the zero keys of the
  tail included (the dense route instead lets pad queries see real keys,
  so the two routes agree at real positions only);
* scores in float32, times ``sm_scale = 1/sqrt(dh)``, plus the kernel's
  finite mask value where the ids differ; the probabilities are cast to
  the input type before the product with v, which accumulates in float32;
  the output is cast back to the input type;
* slices back to s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BLOCK = 128  # the Pallas kernel's block: s is padded to a multiple of it
# DEFAULT_MASK_VALUE of the Pallas kernel: finite, so a row whose first
# keys are all masked never computes exp(-inf + inf)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ids: Optional[torch.Tensor], sm_scale: float,
) -> torch.Tensor:
    """softmax(q k^T * sm_scale + where(ids differ, MASK_VALUE)) v on
    (n, s, nh, dh) tensors, float32 scores, output in q's type."""
    scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * sm_scale
    if ids is not None:
        same = ids[:, None, :, None] == ids[:, None, None, :]
        scores = scores + torch.where(same, 0.0, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("nhqk,nkhd->nqhd", p.to(v.dtype).float(), v.float())
    return (out / l.permute(0, 2, 1, 3)).to(q.dtype)


def pad_to_block(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) by ``pad``."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def flash_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """(n, s, nh, dh) q/k/v -> attention output, same layout and type."""
    n, s = q.shape[0], q.shape[1]
    pad = (-s) % BLOCK
    if pad and mask is None:
        mask = torch.ones((n, s), dtype=torch.float32, device=q.device)
    q, k, v = (pad_to_block(t, pad) for t in (q, k, v))
    ids = None if mask is None else pad_to_block(mask, pad).to(torch.int32)
    out = attention_reference(q, k, v, ids, 1.0 / float(dh) ** 0.5)
    return out[:, :s]
