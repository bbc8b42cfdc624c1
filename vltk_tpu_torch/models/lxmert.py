"""LXMERT and the shared transformer blocks of the port's encoders.

Counterpart of ``vltk_tpu/models/lxmert.py``: ``LxmertConfig`` (same field
set), the flash-attention gate (``_flash_applicable`` /
``_impl_wants_flash`` / ``_flash_eligible``), ``MultiHeadAttention`` with
its dense and flash branches, ``FeedForward``, ``TransformerLayer`` and
``masked_cross_entropy``, which LayoutLM runs on too; and the VQA parts of
LXMERT: ``Embeddings``, ``VisualFeatEncoder``, ``CrossModalityLayer``,
``Pooler``, ``Lxmert``, ``AnswerHead``, ``LxmertForVQA`` and
``vqa_soft_loss``; the pretraining parts: ``MLMHead``, ``VisualHead``,
``LxmertForPretraining``, ``masked_lm_loss``, ``matched_loss``,
``visual_feat_loss``, ``visual_label_loss`` and ``resize_num_qa_labels``.

Module names follow HF ``transformers`` BERT-style layers
(``attention.self.{query,key,value}``, ``attention.output.{dense,LayerNorm}``,
``intermediate.dense``, ``output.{dense,LayerNorm}``) and HF's
``LxmertForQuestionAnswering`` (``lxmert.encoder.{visn_fc,layer,r_layers,
x_layers}``, ``visual_attention.att``, ``lang_inter``, ``answer_head.logit_fc``)
and ``LxmertForPreTraining`` (``cls.predictions``, ``cls.seq_relationship``,
``obj_predict_head``), so an HF state dict loads as it is.

Mixed precision as in flax: parameters stay float32; every projection
casts its input and weights to ``compute_dtype`` (``nn.Dense(dtype=bf16)``);
under ``int8`` the six encoder projection sites (query, key, value, the
attention output, intermediate and the MLP output: the JAX package's
``_proj``) are ``Int8Linear`` layers instead (per-channel int8 weights,
per-tensor int8 activations, int32 sums, output in ``compute_dtype``), with
the same parameter names, and the other dense layers keep the float route;
LayerNorm runs in float32 and returns float32, so the residual stream
between layers is float32; softmax is taken in float32. The embeddings, the
pooler, the answer head and the pretraining heads are flax layers without a
``dtype``, so they run in float32 whatever the config says. The dense route
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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vltk_tpu_torch.models.layers import Int8Linear
from vltk_tpu_torch.models.moe import MoEFeedForward
from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto

NEG_INF = -10000.0  # additive mask value, the BERT/LXMERT convention


@dataclasses.dataclass(frozen=True)
class LxmertConfig:
    """Static hyper-parameters; the field set of the JAX package's
    ``LxmertConfig``. The options that need a mesh raise
    ``NotImplementedError`` in the port for now; ``moe_experts > 0`` puts
    ``models.moe.MoEFeedForward`` in every feed-forward's place; ``remat``
    checkpoints every encoder layer while grad is enabled
    (``encoder_layer``)."""

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
        # each option, and the ROADMAP item that ports it
        unported = {
            "activation_sharding (ROADMAP A.14)": self.activation_sharding,
            "seq_attention_sharding (ROADMAP A.14)": self.seq_attention_sharding,
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


def _proj_layer(cfg: LxmertConfig, in_features: int, out_features: int) -> nn.Linear:
    """An encoder projection site: ``Int8Linear`` under ``cfg.int8``, else
    ``nn.Linear`` (the same parameters either way)."""
    return Int8Linear(in_features, out_features) if cfg.int8 else nn.Linear(in_features, out_features)


def proj(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A projection site's forward: the int8 route for an ``Int8Linear``,
    else ``dense``."""
    return layer(x, dt) if isinstance(layer, Int8Linear) else dense(layer, x, dt)


class _QKV(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.query = _proj_layer(cfg, h, h)
        self.key = _proj_layer(cfg, h, h)
        self.value = _proj_layer(cfg, h, h)


class _DenseNorm(nn.Module):
    """Post-LN residual output: ``LayerNorm(residual + dropout(dense(x)))``
    in float32."""

    def __init__(self, cfg: LxmertConfig, in_features: int):
        super().__init__()
        self.dense = _proj_layer(cfg, in_features, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.dt = cfg.compute_dtype

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        y = self.dropout(proj(self.dense, x, self.dt))
        return self.LayerNorm(residual.float() + y.float())


class _Intermediate(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dense = _proj_layer(cfg, cfg.hidden_size, cfg.intermediate_size)


class MultiHeadAttention(nn.Module):
    """Post-LN residual attention block: ``ln(x + dropout(proj(attn)))``,
    over a context ``ctx`` (``ctx is x`` for self-attention). The q/k/v
    projections sit under ``qkv_name``: HF's ``self``, or ``att`` in
    LXMERT's cross-attention."""

    def __init__(self, cfg: LxmertConfig, qkv_name: str = "self"):
        super().__init__()
        self.cfg = cfg
        self.qkv_name = qkv_name
        self.add_module(qkv_name, _QKV(cfg))
        self.output = _DenseNorm(cfg, cfg.hidden_size)
        self.att_drop = nn.Dropout(cfg.attention_dropout)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                ctx_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        n, s, h = x.shape
        nh, dh = cfg.num_heads, cfg.head_dim
        qkv = getattr(self, self.qkv_name)
        q = proj(qkv.query, x, dt).view(n, s, nh, dh)
        k = proj(qkv.key, ctx, dt).view(n, ctx.shape[1], nh, dh)
        v = proj(qkv.value, ctx, dt).view(n, ctx.shape[1], nh, dh)
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


# a feed-forward's module names: HF's dense intermediate and output, and
# the port's MoE block in their place
_FFN = ("intermediate", "output", "moe")
_LANG_FFN = ("lang_inter", "lang_output", "lang_moe")
_VISN_FFN = ("visn_inter", "visn_output", "visn_moe")


def _add_ffn(module: nn.Module, cfg: LxmertConfig, names: Tuple[str, str, str]) -> None:
    """A layer's feed-forward (the JAX package's ``_ffn_cls``): the dense
    intermediate and output modules, or the MoE block when
    ``cfg.moe_experts > 0``."""
    inter, out, moe = names
    if cfg.moe_experts > 0:
        module.add_module(moe, MoEFeedForward(cfg))
    else:
        module.add_module(inter, _Intermediate(cfg))
        module.add_module(out, _DenseNorm(cfg, cfg.intermediate_size))


def _feed_forward(module: nn.Module, names: Tuple[str, str, str], x: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
    """The feed-forward ``_add_ffn`` built: the MoE block, or the exact-erf
    GELU MLP with post-LN residual."""
    inter, out, moe = names
    if moe in module._modules:
        return module._modules[moe](x)
    y = F.gelu(proj(getattr(module, inter).dense, x, dt), approximate="none")
    return getattr(module, out)(y, x)


class FeedForward(nn.Module):
    """Exact-erf GELU MLP with post-LN residual (BERT intermediate +
    output), or the MoE block ``moe`` under ``cfg.moe_experts > 0``."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        _add_ffn(self, cfg, _FFN)
        self.dt = cfg.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _feed_forward(self, _FFN, x, self.dt)


class TransformerLayer(FeedForward):
    """Single-modality layer: self-attention, then the feed-forward block
    it inherits (so the layer's names are HF's ``attention``,
    ``intermediate`` and ``output``)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__(cfg)
        self.attention = MultiHeadAttention(cfg)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return super().forward(self.attention(x, x, mask))


class CrossModalityLayer(nn.Module):
    """LXMERT x-layer: one cross-attention applied in both directions, each
    reading the other stream as it came in (the visual direction attends
    to the incoming language stream, not the updated one), then
    per-modality self-attention and feed-forward."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dt = cfg.compute_dtype
        self.visual_attention = MultiHeadAttention(cfg, qkv_name="att")
        self.lang_self_att = MultiHeadAttention(cfg)
        self.visn_self_att = MultiHeadAttention(cfg)
        _add_ffn(self, cfg, _LANG_FFN)
        _add_ffn(self, cfg, _VISN_FFN)

    def forward(self, lang: torch.Tensor, lang_mask: Optional[torch.Tensor], visn: torch.Tensor,
                visn_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        lang2 = self.visual_attention(lang, visn, visn_mask)
        visn2 = self.visual_attention(visn, lang, lang_mask)
        lang2 = self.lang_self_att(lang2, lang2, lang_mask)
        visn2 = self.visn_self_att(visn2, visn2, visn_mask)
        lang2 = _feed_forward(self, _LANG_FFN, lang2, self.dt)
        visn2 = _feed_forward(self, _VISN_FFN, visn2, self.dt)
        return lang2, visn2


def encoder_layer(cfg, layer: nn.Module, *args):
    """``layer(*args)``; with ``cfg.remat`` and grad enabled, checkpointed
    (JAX's ``_encoder_layers``: ``nn.remat`` on every encoder layer): the
    backward recomputes the layer from its inputs, replaying dropout with
    the saved RNG state, instead of keeping its activations. A layer on
    the flash route launches K3 again in that recompute."""
    if getattr(cfg, "remat", False) and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=True)
    return layer(*args)


class Embeddings(nn.Module):
    """Word + position + type embeddings, LayerNorm, dropout; float32."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, s = input_ids.shape
        if s > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{self.cfg.max_position_embeddings}; raise it in the config"
            )
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)[None, :].expand(n, s)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos) + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.LayerNorm(x))


class VisualFeatEncoder(nn.Module):
    """Region features and [0, 1] xyxy boxes -> hidden: each projected in
    the compute type, LayerNormed to float32, and averaged."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.dt = cfg.compute_dtype
        self.visn_fc = nn.Linear(cfg.visual_feat_dim, h)
        self.visn_layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.box_fc = nn.Linear(cfg.visual_pos_dim, h)
        self.box_layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        f = self.visn_layer_norm(dense(self.visn_fc, feats, self.dt).float())
        b = self.box_layer_norm(dense(self.box_fc, boxes, self.dt).float())
        return self.dropout((f + b) / 2.0)


class Pooler(nn.Module):
    """tanh(dense(first token)), float32."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, lang: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(lang[:, 0].float()))


class _LxmertEncoder(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.visn_fc = VisualFeatEncoder(cfg)
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.l_layers))
        self.x_layers = nn.ModuleList(CrossModalityLayer(cfg) for _ in range(cfg.x_layers))
        self.r_layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.r_layers))


class Lxmert(nn.Module):
    """The two-stream encoder: (N, S) ids, (N, V, visual_feat_dim)
    features and (N, V, 4) [0, 1] xyxy boxes -> (lang, visn, pooled),
    all float32. Masks are 1 = keep."""

    def __init__(self, cfg: LxmertConfig = LxmertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = _LxmertEncoder(cfg)
        self.pooler = Pooler(cfg)

    def forward(self, input_ids: torch.Tensor, visual_feats: torch.Tensor, visual_pos: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, visual_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None):
        dt = self.cfg.compute_dtype
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.float32, device=input_ids.device)
        attention_mask = attention_mask.float()
        if visual_mask is not None:
            visual_mask = visual_mask.float()
        lang = self.embeddings(input_ids, token_type_ids)
        visn = self.encoder.visn_fc(visual_feats.to(dt), visual_pos.to(dt))
        cfg = self.cfg
        for layer in self.encoder.layer:
            lang = encoder_layer(cfg, layer, lang, attention_mask)
        for layer in self.encoder.r_layers:
            visn = encoder_layer(cfg, layer, visn, visual_mask)
        for layer in self.encoder.x_layers:
            lang, visn = encoder_layer(cfg, layer, lang, attention_mask, visn, visual_mask)
        lang = lang.float()
        return lang, visn.float(), self.pooler(lang)


class AnswerHead(nn.Module):
    """pooled -> dense 2h, GELU, LayerNorm -> num_answers logits, float32
    (HF's ``logit_fc`` sequence: 0 dense, 1 GELU, 2 LayerNorm, 3 dense)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        h2 = 2 * cfg.hidden_size
        self.logit_fc = nn.Sequential(
            nn.Linear(cfg.hidden_size, h2),
            nn.GELU(approximate="none"),
            nn.LayerNorm(h2, eps=cfg.layer_norm_eps),
            nn.Linear(h2, cfg.num_answers),
        )

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.logit_fc(pooled.float())


class LxmertForVQA(nn.Module):
    """The encoder and the answer head: -> (N, num_answers) float32 logits."""

    def __init__(self, cfg: LxmertConfig = LxmertConfig()):
        super().__init__()
        self.cfg = cfg
        self.lxmert = Lxmert(cfg)
        self.answer_head = AnswerHead(cfg)

    def forward(self, input_ids, visual_feats, visual_pos, attention_mask=None, visual_mask=None,
                token_type_ids=None) -> torch.Tensor:
        _, _, pooled = self.lxmert(input_ids, visual_feats, visual_pos, attention_mask, visual_mask, token_type_ids)
        return self.answer_head(pooled)


class _HeadTransform(nn.Module):
    """dense, GELU, LayerNorm, float32 (HF's ``LxmertPredictionHeadTransform``)."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(F.gelu(self.dense(x.float()), approximate="none"))


class MLMHead(nn.Module):
    """The BERT LM head over the language stream: transform, then decode to
    the vocabulary, float32. Untied from the word embeddings, as in the
    JAX package; HF keeps the decoder's bias at ``cls.predictions.bias``."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.transform = _HeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, lang: torch.Tensor) -> torch.Tensor:
        return F.linear(self.transform(lang), self.decoder.weight, self.bias)


class VisualHead(nn.Module):
    """The visual pretraining heads over the visual stream: transform, then
    object logits, attribute logits and the regressed feature, float32."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.transform = _HeadTransform(cfg)
        self.decoder_dict = nn.ModuleDict({
            "obj": nn.Linear(h, cfg.num_objects),
            "attr": nn.Linear(h, cfg.num_attrs),
            "feat": nn.Linear(h, cfg.visual_feat_dim),
        })

    def forward(self, visn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.transform(visn)
        return tuple(self.decoder_dict[k](x) for k in ("obj", "attr", "feat"))


class _PretrainingHeads(nn.Module):
    """HF's ``cls``: the LM head and the matched (sequence relationship) head."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.predictions = MLMHead(cfg)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)


class LxmertForPretraining(nn.Module):
    """The encoder and every pretraining head. Returns a dict of float32
    tensors: ``lang``, ``visn``, ``pooled``, ``mlm_logits``,
    ``matched_logits``, ``obj_logits``, ``attr_logits``, ``feat_pred`` and
    ``qa_logits``; which losses apply is the train config's task toggles."""

    def __init__(self, cfg: LxmertConfig = LxmertConfig()):
        super().__init__()
        self.cfg = cfg
        self.lxmert = Lxmert(cfg)
        self.cls = _PretrainingHeads(cfg)
        self.obj_predict_head = VisualHead(cfg)
        self.answer_head = AnswerHead(cfg)

    def forward(self, input_ids, visual_feats, visual_pos, attention_mask=None, visual_mask=None,
                token_type_ids=None):
        lang, visn, pooled = self.lxmert(input_ids, visual_feats, visual_pos, attention_mask, visual_mask,
                                         token_type_ids)
        obj, attr, feat = self.obj_predict_head(visn)
        return {
            "lang": lang, "visn": visn, "pooled": pooled,
            "mlm_logits": self.cls.predictions(lang),
            "matched_logits": self.cls.seq_relationship(pooled),
            "obj_logits": obj, "attr_logits": attr, "feat_pred": feat,
            "qa_logits": self.answer_head(pooled),
        }


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -100) -> torch.Tensor:
    """Cross entropy averaged over the positions whose label is not
    ``ignore_id``, over the whole batch; 0 (not NaN) when none is. Float32
    log-softmax, as the JAX package's."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp(min=1)


def vqa_soft_loss(logits: torch.Tensor, target_scores: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE with logits against VQA soft scores, in the stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``, averaged and scaled by the
    number of answers (the LXMERT convention). Float32."""
    x = logits.float()
    per = torch.clamp(x, min=0.0) - x * target_scores.float() + torch.log1p(torch.exp(-x.abs()))
    return per.mean() * x.shape[-1]


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -100) -> torch.Tensor:
    """Cross entropy over the positions whose ``masked_labels`` are not
    ``ignore_id`` (``processing.lang.masked_language_modeling`` writes them)."""
    return masked_cross_entropy(logits, labels, ignore_id)


def matched_loss(logits: torch.Tensor, is_matched: torch.Tensor) -> torch.Tensor:
    """Cross-modality matching cross entropy over (N, 2) logits, float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, is_matched.long()[:, None]).mean()


def visual_feat_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Squared error of the regressed region features, summed over the
    feature and averaged over the masked regions (``mask`` (N, V), 1 = was
    masked; at least 1 in the denominator)."""
    err = ((pred.float() - target) ** 2).sum(-1)
    return (err * mask).sum() / mask.sum().clamp(min=1.0)


def visual_label_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cross entropy of masked regions' object or attribute labels,
    averaged over the masked regions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def resize_num_qa_labels(state_dict, num_answers: int, generator: torch.Generator):
    """A state dict whose answer head's last layer
    (``answer_head.logit_fc.3``) is resized to ``num_answers``: the rows
    both sizes share are kept exactly, new rows are drawn normal x 0.02
    from ``generator`` (on the CPU) and new biases are 0. Returns the
    state dict itself when the size already matches; raises ``KeyError``
    when it has no answer head."""
    wkey, bkey = "answer_head.logit_fc.3.weight", "answer_head.logit_fc.3.bias"
    if wkey not in state_dict:
        raise KeyError("state dict has no answer_head.logit_fc.3")
    weight, bias = state_dict[wkey], state_dict[bkey]
    old_n, in_dim = weight.shape
    if old_n == num_answers:
        return state_dict
    keep = min(old_n, num_answers)
    new_weight = (torch.randn((num_answers, in_dim), generator=generator) * 0.02).to(weight.dtype)
    new_weight[:keep] = weight[:keep].cpu()
    new_bias = torch.zeros((num_answers,), dtype=bias.dtype)
    new_bias[:keep] = bias[:keep].cpu()
    return {**state_dict, wkey: new_weight.to(weight.device), bkey: new_bias.to(bias.device)}


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: normal(0, initializer_range) for every
    projection, embedding table and MoE expert stack, zero biases, unit LayerNorms (the flax
    initialisers of the JAX package, not its random draws). Deterministic
    for a seed whatever the device: the numbers are drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    std = model.cfg.initializer_range
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MLMHead):
                mod.bias.zero_()
            elif isinstance(mod, MoEFeedForward):
                for w in (mod.wi, mod.wo):
                    w.copy_(torch.randn(w.shape, generator=gen) * std)
                mod.bi.zero_()
                mod.bo.zero_()
    return model
