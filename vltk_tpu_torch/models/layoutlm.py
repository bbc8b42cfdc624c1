"""LayoutLM OCR-document encoder of the port.

Counterpart of ``vltk_tpu/models/layoutlm.py``: BERT-style token
embeddings plus the shared x (left/right), shared y (top/bottom), height
and width coordinate embeddings, all summed before the LayerNorm; a
single-stream stack of ``TransformerLayer``; per-token classification and
extractive span-QA heads and their losses. Module and state-dict names are those of HF
``transformers.LayoutLMModel`` / ``LayoutLMForTokenClassification`` /
``LayoutLMForQuestionAnswering`` (without the pooler), so an HF state dict
loads as it is.

``LayoutLMConfig.attention_impl`` defaults to ``"auto"``: at padded length
>= 1024 on the card every self-attention runs the flash kernel K3
(``csrc/flash_attention.cu``); shorter streams and the CPU take the dense
route. Under a mesh with ``activation_sharding`` the stream is cut over
the ``seq`` axis between the embeddings and the heads, as LXMERT's
language stream is (``models.lxmert.SeqShard``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vltk_tpu_torch.models.lxmert import (  # noqa: F401  (init_weights is re-exported)
    LxmertConfig,
    TransformerLayer,
    embed_words,
    encoder_layer,
    init_weights,
    masked_cross_entropy,
    seq_shard,
)


@dataclasses.dataclass(frozen=True)
class LayoutLMConfig(LxmertConfig):
    """Single-stream depth in ``l_layers``; ``num_labels`` is the per-token
    class count; ``coord_vocab`` the 2D coordinate table size."""

    l_layers: int = 12
    num_labels: int = 4
    coord_vocab: int = 1024
    attention_impl: str = "auto"


class LayoutLMEmbeddings(nn.Module):
    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.x_position_embeddings = nn.Embedding(cfg.coord_vocab, h)
        self.y_position_embeddings = nn.Embedding(cfg.coord_vocab, h)
        self.h_position_embeddings = nn.Embedding(cfg.coord_vocab, h)
        self.w_position_embeddings = nn.Embedding(cfg.coord_vocab, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids: torch.Tensor, boxes: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        n, s = input_ids.shape
        if s > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}; raise it in the config"
            )
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        top = cfg.coord_vocab - 1
        b = boxes.to(torch.int64).clamp(0, top)
        h = (b[..., 3] - b[..., 1]).clamp(0, top)
        w = (b[..., 2] - b[..., 0]).clamp(0, top)
        pos = torch.arange(s, device=input_ids.device)[None, :].expand(n, s)
        emb = (
            embed_words(self.word_embeddings, input_ids)
            + self.position_embeddings(pos)
            + self.token_type_embeddings(token_type_ids)
            + self.x_position_embeddings(b[..., 0])
            + self.y_position_embeddings(b[..., 1])
            + self.x_position_embeddings(b[..., 2])
            + self.y_position_embeddings(b[..., 3])
            + self.h_position_embeddings(h)
            + self.w_position_embeddings(w)
        )
        return self.dropout(self.LayerNorm(emb))


class _Encoder(nn.Module):
    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.l_layers))


class LayoutLM(nn.Module):
    """(ids, boxes) -> sequence (N, L, H) float32. Boxes are (N, L, 4)
    integers in [0, 1000], xyxy (the OCRBoxFixed output)."""

    def __init__(self, cfg: LayoutLMConfig = LayoutLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = LayoutLMEmbeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, token_boxes: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embeddings(input_ids, token_boxes, token_type_ids)
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.float32, device=x.device)
        mask = attention_mask.float()
        seq = seq_shard(self.cfg)  # under a mesh: the stream cut over ``seq``
        if seq is not None:
            x = seq.split(x)
        for layer in self.encoder.layer:
            x = encoder_layer(self.cfg, layer, x, mask, seq)
        return x if seq is None else seq.gather(x)


class LayoutLMForTokenClassification(nn.Module):
    """Per-token logits over form-understanding labels (float32 head)."""

    def __init__(self, cfg: LayoutLMConfig = LayoutLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.layoutlm = LayoutLM(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, token_boxes, attention_mask=None, token_type_ids=None):
        x = self.layoutlm(input_ids, token_boxes, attention_mask, token_type_ids)
        return self.classifier(self.dropout(x))


class LayoutLMForSpanQA(nn.Module):
    """Extractive span QA over OCR sub-tokens: (start, end) logits, pad
    positions pushed down by ``(1 - mask) * -10000``."""

    def __init__(self, cfg: LayoutLMConfig = LayoutLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.layoutlm = LayoutLM(cfg)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_boxes, attention_mask=None,
                token_type_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.layoutlm(input_ids, token_boxes, attention_mask, token_type_ids)
        logits = self.qa_outputs(x)
        start, end = logits[..., 0], logits[..., 1]
        if attention_mask is not None:
            bias = (1.0 - attention_mask.float()) * -10000.0
            start, end = start + bias, end + bias
        return start, end


def token_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_id: int = -100) -> torch.Tensor:
    """Token-level cross entropy ignoring padded and unlabelled positions."""
    return masked_cross_entropy(logits, labels, ignore_id)


def span_qa_loss(start_logits: torch.Tensor, end_logits: torch.Tensor, span_start: torch.Tensor,
                 span_end: torch.Tensor, ignore_id: int = -100) -> torch.Tensor:
    """Mean cross entropy over start and end positions, rows with
    ``ignore_id`` skipped."""
    return (masked_cross_entropy(start_logits, span_start, ignore_id)
            + masked_cross_entropy(end_logits, span_end, ignore_id)) / 2
