"""Ring attention over the ``seq`` mesh axis.

Counterpart of ``vltk_tpu/parallel/ring.py``, the second sequence-parallel
backend beside Ulysses: queries stay sequence-cut and the K/V blocks (with
their key mask) travel around the ring, ``rotate`` to rank i + 1 after
each block, ``sp`` times, so the sequence degree is not capped by the
head count and no rank holds more than an (s/sp, s/sp) score block a head.

The softmax is online (running row max ``m``, normaliser ``l``,
unnormalised accumulator ``o``) in float32 whatever the compute type,
with the additive ``NEG_INF = -10000`` mask; the block products run in
the compute type, as JAX's einsums do outside any Pallas kernel.
Autograd goes through the loop (``rotate``'s backward sends the cotangent
back to rank i - 1); the saved blocks make the backward's K/V footprint
the whole sequence, as JAX's scan carries do.

Attention dropout is drawn block by block from ``torch.Generator``s keyed
by (seed, q shard, kv shard, data and model coordinates): every score
position of every rank gets its own reproducible draw, whatever the ring
schedule. It is valid dropout but not JAX's draw, so parity runs
deterministic, as JAX's own tests do.
"""

from __future__ import annotations

from typing import Optional

import torch

from vltk_tpu_torch.parallel.collectives import rotate

NEG_INF = -10000.0  # additive-mask value, as models/lxmert.py


def _block_generator(device: torch.device, *key: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(hash(tuple(key)) & ((1 << 63) - 1))
    return gen


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    mesh,
    seq_axis: str = "seq",
    data_axis: str = "data",
    model_axis: str = "model",
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bidirectional self-attention of this rank's sequence block.

    Args:
      q, k, v: ``(n, s / sp, nh, dh)`` local blocks (the rank's examples
        and heads); block i of the sequence on ``seq`` coordinate i.
      mask: ``(n, s / sp)`` float key mask of the same block (1 = attend),
        or None.
      mesh: the ``parallel.Mesh``; ``data_axis`` / ``model_axis`` key the
        dropout where the mesh has them.
      dropout_rate / dropout_seed: blockwise attention dropout; a seed is
        required when the rate is > 0.
      compute_dtype: the type of the two block products.

    Returns the ``(n, s / sp, nh, dh)`` output block in ``compute_dtype``.
    """
    if seq_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no {seq_axis!r} axis")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    sp = mesh.shape[seq_axis]
    group = mesh.group(seq_axis)
    my = mesh.coord(seq_axis)
    n, sq, nh, dh = q.shape
    if mask is None:
        mask = torch.ones((n, k.shape[1]), dtype=torch.float32, device=q.device)
    scale = 1.0 / float(dh) ** 0.5
    qb = q.to(compute_dtype)
    m = torch.full((n, nh, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((n, nh, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((n, nh, sq, dh), dtype=torch.float32, device=q.device)
    kc, vc, mc = k, v, mask.float()
    for step in range(sp):
        sc = torch.einsum("nqhd,nkhd->nhqk", qb, kc.to(compute_dtype)).float() * scale
        sc = sc + (1.0 - mc)[:, None, None, :] * NEG_INF
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if dropout_rate > 0.0:
            # the kv block at ring step t came from seq rank (my - t) % sp
            src = (my - step) % sp
            gen = _block_generator(q.device, dropout_seed, my, src, mesh.coord(data_axis), mesh.coord(model_axis))
            keep = torch.rand(p.shape, generator=gen, device=p.device) < 1.0 - dropout_rate
            p_av = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
        else:
            p_av = p
        o = o * corr[..., None] + torch.einsum(
            "nhqk,nkhd->nhqd", p_av.to(compute_dtype), vc.to(compute_dtype)).float()
        m = m_new
        kc, vc, mc = rotate(kc, group), rotate(vc, group), rotate(mc, group)
    out = (o / l[..., None]).to(compute_dtype)  # (n, nh, sq, dh)
    return out.transpose(1, 2)
