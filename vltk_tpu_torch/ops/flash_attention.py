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

The backward (``flash_self_attention_backward``) follows the Pallas
custom VJP that JAX differentiates ``_flash_self_attention`` with
(``jax/experimental/pallas/ops/tpu/flash_attention.py``: ``di`` in
``_flash_attention_bwd``, the ``dkv`` and ``dq`` kernel bodies). It reads
the forward's row statistics as the Pallas kernel keeps them: ``m``, the
row max of the masked, scaled float32 scores, and ``l``, the row sum of
``exp(scores - m)``, both natural-log units, float32 (n, nh, s). Rows past
s (the pad to 128) are not kept: their output gradient is zero, so they
add nothing to dk and dv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 128  # the Pallas kernel's block: s is padded to a multiple of it
# DEFAULT_MASK_VALUE of the Pallas kernel: finite, so a row whose first
# keys are all masked never computes exp(-inf + inf)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _scores(q: torch.Tensor, k: torch.Tensor, ids: Optional[torch.Tensor],
            sm_scale: float) -> torch.Tensor:
    """(n, nh, q, k) float32 scores times ``sm_scale``, plus MASK_VALUE
    where the segment ids differ."""
    scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * sm_scale
    if ids is not None:
        same = ids[:, None, :, None] == ids[:, None, None, :]
        scores = scores + torch.where(same, 0.0, MASK_VALUE)
    return scores


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ids: Optional[torch.Tensor], sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """softmax(q k^T * sm_scale + where(ids differ, MASK_VALUE)) v on
    (n, s, nh, dh) tensors, float32 scores, output in q's type; also the
    row statistics m and l, float32 (n, nh, s)."""
    scores = _scores(q, k, ids, sm_scale)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("nhqk,nkhd->nqhd", p.to(v.dtype).float(), v.float())
    return (out / l.permute(0, 2, 1, 3)).to(q.dtype), m[..., 0], l[..., 0]


def pad_to_block(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) by ``pad``."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _padded(q, mask):
    """The JAX function's padding: s up to a multiple of 128, an all-ones
    mask synthesised first when ``mask`` is None and s needs padding,
    segment ids = the padded mask as int32."""
    n, s = q.shape[0], q.shape[1]
    pad = (-s) % BLOCK
    if pad and mask is None:
        mask = torch.ones((n, s), dtype=torch.float32, device=q.device)
    ids = None if mask is None else pad_to_block(mask, pad).to(torch.int32)
    return pad, ids


def flash_self_attention_fwd_residuals(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(n, s, nh, dh) q/k/v -> (attention output, (m, l)): the output as
    ``flash_self_attention`` gives it, and the row statistics the backward
    reads, float32 (n, nh, s)."""
    s = q.shape[1]
    pad, ids = _padded(q, mask)
    q, k, v = (pad_to_block(t, pad) for t in (q, k, v))
    out, m, l = attention_reference(q, k, v, ids, 1.0 / float(dh) ** 0.5)  # noqa: E741
    return out[:, :s], (m[..., :s], l[..., :s])


def flash_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """(n, s, nh, dh) q/k/v -> attention output, same layout and type."""
    return flash_self_attention_fwd_residuals(q, k, v, mask, dh)[0]


def flash_self_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], o: torch.Tensor,
    stats: Tuple[torch.Tensor, torch.Tensor], do: torch.Tensor, dh: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_self_attention`` for the output gradient
    ``do``, from the forward's output ``o`` (input type) and statistics
    ``stats = (m, l)``, step for step as the Pallas backward:

    * ``di = sum(o * do)`` over dh in float32;
    * ``p = exp(s - m) * (1 / l)`` in float32;
    * ``dv = p^T do`` with p cast to do's type, float32 accumulation;
    * ``dp = do v^T``; ``ds = (dp - di) * p * sm_scale``;
    * ``dk = ds^T q`` and ``dq = ds k`` with ds cast to the input type;
    * outputs in the input type, sliced back to s.
    """
    s = q.shape[1]
    sm_scale = 1.0 / float(dh) ** 0.5
    pad, ids = _padded(q, mask)
    q, k, v, o, do = (pad_to_block(t, pad) for t in (q, k, v, o, do))
    m, l = (F.pad(t.float(), (0, pad), value=fill) for t, fill in zip(stats, (0.0, 1.0)))  # noqa: E741
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1)  # (n, nh, s_pad)
    p = torch.exp(_scores(q, k, ids, sm_scale) - m[..., None]) * (1.0 / l[..., None])
    dt = q.dtype
    dv = torch.einsum("nhqk,nqhd->nkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("nqhd,nkhd->nhqk", do.float(), v.float())
    ds = ((dp - di[..., None]) * p * sm_scale).to(dt).float()
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.float())
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.float())
    return tuple(g[:, :s].to(dt) for g in (dq, dk, dv))
