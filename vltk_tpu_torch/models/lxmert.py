"""Shared transformer blocks of the port's encoders.

Counterpart of the encoder parts of ``vltk_tpu/models/lxmert.py``:
``LxmertConfig`` (same field set), the flash-attention gate
(``_flash_applicable`` / ``_impl_wants_flash`` / ``_flash_eligible``),
``MultiHeadAttention`` with its dense and flash branches,
``FeedForward``, ``TransformerLayer`` and ``masked_cross_entropy``. LayoutLM
runs on them now;
VisualBERT, ViT and LXMERT reuse them later.

Module names follow HF ``transformers`` BERT-style layers
(``attention.self.{query,key,value}``, ``attention.output.{dense,LayerNorm}``,
``intermediate.dense``, ``output.{dense,LayerNorm}``), so an HF state dict
loads as it is.

Mixed precision as in flax: parameters stay float32; every projection
casts its input and weights to ``compute_dtype`` (``nn.Dense(dtype=bf16)``);
LayerNorm runs in float32 and returns float32, so the residual stream
between layers is float32; softmax is taken in float32. The dense route
divides the ``compute_dtype`` scores by sqrt(dh) in that type and adds
``(1 - mask) * -10000``; the flash route (``ops/flash_attention_kernel.py``,
the CUDA kernel K3 on the card) uses segment ids and a float32 scale, so pad
queries differ between the routes and they agree at real positions only.
In training the flash route is differentiable on the card as well: the
dispatcher runs K3 with its row statistics and the backward kernels K4 and
K5 behind a ``torch.autograd.Function``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto

NEG_INF = -10000.0  # additive mask value, the BERT/LXMERT convention


@dataclasses.dataclass(frozen=True)
class LxmertConfig:
    """Static hyper-parameters; the field set of the JAX package's
    ``LxmertConfig``. The options that need a mesh, MoE, int8 or remat
    raise ``NotImplementedError`` in the port for now."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    num_answers: int = 3129
    num_objects: int = 1600
    num_attrs: int = 400
    ignore_id: int = -100
    dtype: Optional[str] = None  # "bfloat16": compute type; params stay f32
    activation_sharding: bool = False
    seq_attention_sharding: bool = False
    seq_attention_backend: str = "ulysses"
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # "xla": dense attention; "flash": the flash kernel where the gate
    # allows; "auto": flash at padded length >= 1024
    attention_impl: str = "xla"
    int8: bool = False

    def __post_init__(self):
        unported = {
            "activation_sharding": self.activation_sharding,
            "seq_attention_sharding": self.seq_attention_sharding,
            "moe_experts > 0": self.moe_experts > 0,
            "int8": self.int8,
            "remat": self.remat,
        }
        on = [name for name, value in unported.items() if value]
        if on:
            raise NotImplementedError(f"not ported yet: {', '.join(on)}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype is None else getattr(torch, self.dtype)


def _flash_applicable(s: int, deterministic: bool, attention_dropout: float,
                      device: torch.device) -> bool:
    """Shape and mode gate of the flash route: sequence length at least one
    128 block, attention dropout inactive, and running on CUDA (JAX asks for
    the TPU here), so on the CPU the model takes the dense path exactly as
    the JAX package does off the TPU."""
    return (
        s >= 128
        and (deterministic or attention_dropout == 0.0)
        and device.type == "cuda"
    )


def _impl_wants_flash(cfg, s: int) -> bool:
    """``attention_impl`` policy: "xla" never, "flash" always (where the
    gate allows), "auto" at padded length >= 1024."""
    impl = getattr(cfg, "attention_impl", "xla")
    if impl == "flash":
        return True
    return impl == "auto" and s + ((-s) % 128) >= 1024


def _flash_eligible(x, ctx, s: int, deterministic: bool, cfg) -> bool:
    """Self-attention (``ctx is x``) that passes ``_flash_applicable``."""
    return ctx is x and _flash_applicable(s, deterministic, cfg.attention_dropout, x.device)


def dense(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: input, weight and bias cast to ``dt``."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


class _QKV(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class _DenseNorm(nn.Module):
    """Post-LN residual output: ``LayerNorm(residual + dropout(dense(x)))``
    in float32."""

    def __init__(self, cfg: LxmertConfig, in_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.dt = cfg.compute_dtype

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        y = self.dropout(dense(self.dense, x, self.dt))
        return self.LayerNorm(residual.float() + y.float())


class _Intermediate(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class MultiHeadAttention(nn.Module):
    """Post-LN residual attention block: ``ln(x + dropout(proj(attn)))``,
    over a context ``ctx`` (``ctx is x`` for self-attention)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.cfg = cfg
        self.self = _QKV(cfg)
        self.output = _DenseNorm(cfg, cfg.hidden_size)
        self.att_drop = nn.Dropout(cfg.attention_dropout)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                ctx_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        n, s, h = x.shape
        nh, dh = cfg.num_heads, cfg.head_dim
        q = dense(self.self.query, x, dt).view(n, s, nh, dh)
        k = dense(self.self.key, ctx, dt).view(n, ctx.shape[1], nh, dh)
        v = dense(self.self.value, ctx, dt).view(n, ctx.shape[1], nh, dh)
        if _impl_wants_flash(cfg, s) and _flash_eligible(x, ctx, s, not self.training, cfg):
            out4 = flash_attention_auto(q, k, v, ctx_mask, dh)
            return self.output(out4.reshape(n, s, h), x)
        # sqrt(dh) rounded to the compute type, as jnp.sqrt(jnp.asarray(dh, dt))
        root = float(torch.tensor(float(dh), dtype=dt).sqrt())
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / root
        if ctx_mask is not None:
            bias = (1.0 - ctx_mask[:, None, None, :].float()) * NEG_INF
            scores = scores + bias.to(scores.dtype)
        probs = self.att_drop(torch.softmax(scores.float(), dim=-1).to(dt))
        out4 = torch.einsum("nhqk,nkhd->nqhd", probs, v)
        return self.output(out4.reshape(n, s, h), x)


class FeedForward(nn.Module):
    """Exact-erf GELU MLP with post-LN residual (BERT intermediate +
    output)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg, cfg.intermediate_size)
        self.dt = cfg.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(dense(self.intermediate.dense, x, self.dt), approximate="none")
        return self.output(y, x)


class TransformerLayer(FeedForward):
    """Single-modality layer: self-attention, then the feed-forward block
    it inherits (so the layer's names are HF's ``attention``,
    ``intermediate`` and ``output``)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__(cfg)
        self.attention = MultiHeadAttention(cfg)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return super().forward(self.attention(x, x, mask))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -100) -> torch.Tensor:
    """Cross entropy averaged over the positions whose label is not
    ``ignore_id``, over the whole batch; 0 (not NaN) when none is. Float32
    log-softmax, as the JAX package's."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp(min=1)
