"""ViT image encoder of the port.

Counterpart of ``vltk_tpu/models/vit.py``: a pre-LN ViT (patch conv, CLS
token and learned positions, attention and MLP blocks, a final LayerNorm
and a tanh pooler) over NHWC images. Module and state-dict names are HF
``transformers.ViTModel``'s (``embeddings.{cls_token,position_embeddings,
patch_embeddings.projection}``, ``encoder.layer.i.{layernorm_before,
attention.attention.{query,key,value},attention.output.dense,
layernorm_after,intermediate.dense,output.dense}``, ``layernorm``,
``pooler.dense``), so an HF state dict loads as it is.

Mixed precision as in flax, which differs from the BERT-style layers:
the patch conv, the projections and the attention run in
``compute_dtype``; the pre-LN norms are float32 and the residual adds in
the promoted type, so under bf16 the residual stream stays bf16; the dense
attention divides the compute-type scores by sqrt(dh) rounded to that type
and takes the softmax in float32; the final norm and the pooler run in
float32. ``attention_impl="flash"`` sends each self-attention (no mask:
every patch is real) to the flash kernel K3 on the card; on the CPU, and
under ``"auto"`` at ViT's padded 256, the dense route runs. Under
``int8`` the six projection sites of each layer are ``Int8Linear`` layers;
the patch conv and the pooler stay float.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.models.lxmert import (
    _QKV,
    _flash_applicable,
    _impl_wants_flash,
    _Intermediate,
    _proj_layer,
    proj,
)
from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The field set and defaults of the JAX package's ``ViTConfig``:
    ViT-B/16 at 224."""

    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    dtype: Optional[str] = None  # "bfloat16": compute type; params stay f32
    # "xla": dense attention; "flash": the flash kernel where the gate
    # allows; "auto": flash at padded length >= 1024 (never at 224)
    attention_impl: str = "xla"
    int8: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype is None else getattr(torch, self.dtype)


class _Dense(nn.Module):
    """HF's ``ViTSelfOutput`` / ``ViTOutput``: one projection site, ``dense``."""

    def __init__(self, cfg: ViTConfig, in_features: int, out_features: int):
        super().__init__()
        self.dense = _proj_layer(cfg, in_features, out_features)


class _ViTAttention(nn.Module):
    """HF's ``ViTAttention``: q/k/v at ``attention`` and the output
    projection at ``output.dense``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.attention = _QKV(cfg)
        self.output = _Dense(cfg, cfg.hidden_size, cfg.hidden_size)


def _add_attention(m: nn.Module, cfg: ViTConfig) -> None:
    m.cfg = cfg
    m.layernorm_before = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
    m.attention = _ViTAttention(cfg)
    m.att_drop = nn.Dropout(cfg.attention_dropout)
    m.out_drop = nn.Dropout(cfg.hidden_dropout)


def _add_mlp(m: nn.Module, cfg: ViTConfig) -> None:
    m.cfg = cfg
    m.layernorm_after = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
    m.intermediate = _Intermediate(cfg)
    m.output = _Dense(cfg, cfg.intermediate_size, cfg.hidden_size)
    m.mlp_drop = nn.Dropout(cfg.hidden_dropout)


def _attention(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x + att_out(attention(ln_before(x)))``."""
    cfg = m.cfg
    dt = cfg.compute_dtype
    n, s, hd = x.shape
    nh = cfg.num_heads
    dh = hd // nh
    y = m.layernorm_before(x.float())
    qkv = m.attention.attention
    q = proj(qkv.query, y, dt).view(n, s, nh, dh)
    k = proj(qkv.key, y, dt).view(n, s, nh, dh)
    v = proj(qkv.value, y, dt).view(n, s, nh, dh)
    if _impl_wants_flash(cfg, s) and _flash_applicable(s, not m.training, cfg.attention_dropout, x.device):
        out = flash_attention_auto(q, k, v, None, dh).reshape(n, s, hd)
    else:
        # sqrt(dh) rounded to the compute type, as jnp.sqrt(jnp.asarray(dh, dt))
        root = float(torch.tensor(float(dh), dtype=dt).sqrt())
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / root
        probs = m.att_drop(torch.softmax(scores.float(), dim=-1).to(dt))
        out = torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(n, s, hd)
    out = m.out_drop(proj(m.attention.output.dense, out, dt))
    return x + out


def _mlp(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp_out(gelu(intermediate(ln_after(x))))``, exact GELU."""
    dt = m.cfg.compute_dtype
    y = m.layernorm_after(x.float())
    y = F.gelu(proj(m.intermediate.dense, y, dt), approximate="none")
    y = m.mlp_drop(proj(m.output.dense, y, dt))
    return x + y


class _PreLNAttention(nn.Module):
    """The attention half of a ViT layer (flax's ``layer_i_att``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        _add_attention(self, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _attention(self, x)


class _PreLNMLP(nn.Module):
    """The MLP half of a ViT layer (flax's ``layer_i_mlp``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        _add_mlp(self, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp(self, x)


class ViTLayer(nn.Module):
    """One ViT layer: ``_PreLNAttention`` then ``_PreLNMLP``, their modules
    under HF's flat ``ViTLayer`` names."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        _add_attention(self, cfg)
        _add_mlp(self, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp(self, _attention(self, x))


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size)


class _ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, h))
        self.patch_embeddings = _PatchEmbeddings(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)


class _Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_layers))


class _Pooler(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class ViT(nn.Module):
    """(N, H, W, 3) images -> (sequence (N, 1 + P, hidden) float32, pooled
    (N, hidden) float32)."""

    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _ViTEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.pooler = _Pooler(cfg)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> the (N, 1 + P, hidden) stream in the compute
        type: the patch conv on NHWC input, the CLS token, the positions."""
        cfg, emb = self.cfg, self.embeddings
        dt = cfg.compute_dtype
        n, h = images.shape[0], cfg.hidden_size
        conv = emb.patch_embeddings.projection
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride)
        x = x.permute(0, 2, 3, 1).reshape(n, -1, h)
        x = torch.cat([emb.cls_token.expand(n, 1, h).to(dt), x], dim=1)
        return emb.dropout(x + emb.position_embeddings.to(dt))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(images)
        for layer in self.encoder.layer:
            x = layer(x)
        x = self.layernorm(x.float())
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


def init_vit_weights(model: ViT, seed: int = 0) -> ViT:
    """Seeded random weights with flax's initialisers of the JAX package:
    normal(0, initializer_range) for the projections, the CLS token and the
    position table, zero biases, unit LayerNorms, and flax's default
    (LeCun normal, truncated) for the patch conv. Drawn on the CPU, so the
    numbers do not depend on the device."""
    from vltk_tpu_torch.models.layers import lecun_normal_

    gen = torch.Generator().manual_seed(seed)
    std = model.cfg.initializer_range
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                w = torch.empty(mod.weight.shape)
                lecun_normal_(w, mod.weight[0].numel(), gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
        for p in (model.embeddings.cls_token, model.embeddings.position_embeddings):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model
