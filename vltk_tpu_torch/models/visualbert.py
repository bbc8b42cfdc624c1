"""VisualBERT single-stream vision-language encoder of the port.

Counterpart of ``vltk_tpu/models/visualbert.py``: ``[CLS] text [SEP]``
tokens and projected region features appended as visual tokens, one
stream through the shared ``TransformerLayer``s. Module and state-dict
names are HF ``transformers.VisualBertModel``'s; the classifier
(``VisualBertForClassification``) is HF's ``VisualBertForVisualReasoning``
layout: ``visual_bert.*``, then ``dropout`` and the linear ``cls``. So an
HF state dict of either loads as it is.

Masks are concatenated ``[text mask | visual mask]``, so a padded question
leaves a hole in mid-stream (real text, pad text, the visual tokens): on
the card the flash route takes segment ids from that mask, as span QA
does. ``visual_pos`` is accepted for the LXMERT family's call signature
and unused: HF's VisualBERT has no box pathway.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vltk_tpu_torch.models.layoutlm import _Encoder
from vltk_tpu_torch.models.lxmert import LxmertConfig, Pooler, dense, encoder_layer


@dataclasses.dataclass(frozen=True)
class VisualBertConfig(LxmertConfig):
    """Single-stream depth in ``l_layers`` (12, as visualbert-vqa);
    ``x_layers`` and ``r_layers`` are unused. ``num_labels`` is the
    classifier's class count (hateful memes: 2)."""

    l_layers: int = 12
    num_labels: int = 2


class VisualBertEmbeddings(nn.Module):
    """Text: word + token type + position embeddings. Visual tokens: the
    projected features (in the compute type, cast to float32) + the visual
    token type (1) + the visual position (id 0). One LayerNorm over the
    concatenated stream, then dropout; float32."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.visual_token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.visual_position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.visual_projection = nn.Linear(cfg.visual_feat_dim, h)

    def forward(self, input_ids: torch.Tensor, visual_feats: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        n, s = input_ids.shape
        v = visual_feats.shape[1]
        if max(s, v) > cfg.max_position_embeddings:
            raise ValueError(
                f"stream length {max(s, v)} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}; raise it in the config"
            )
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        dev = input_ids.device
        pos = torch.arange(s, device=dev)[None, :].expand(n, s)
        text = self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids) + self.position_embeddings(pos)
        vis = dense(self.visual_projection, visual_feats, cfg.compute_dtype).to(text.dtype)
        vis = vis + self.visual_token_type_embeddings(torch.ones((n, v), dtype=torch.long, device=dev))
        vis = vis + self.visual_position_embeddings(torch.zeros((n, v), dtype=torch.long, device=dev))
        return self.dropout(self.LayerNorm(torch.cat([text, vis], dim=1)))


class VisualBert(nn.Module):
    """(N, S) ids and (N, V, visual_feat_dim) features -> (sequence (N,
    S + V, hidden), pooled (N, hidden)), float32. Masks are 1 = keep."""

    def __init__(self, cfg: VisualBertConfig = VisualBertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = VisualBertEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = Pooler(cfg)

    def forward(self, input_ids: torch.Tensor, visual_feats: torch.Tensor,
                visual_pos: Optional[torch.Tensor] = None, attention_mask: Optional[torch.Tensor] = None,
                visual_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        del visual_pos  # no box pathway in VisualBERT
        n, s = input_ids.shape
        v = visual_feats.shape[1]
        x = self.embeddings(input_ids, visual_feats, token_type_ids)
        if attention_mask is None:
            attention_mask = torch.ones((n, s), device=x.device)
        if visual_mask is None:
            visual_mask = torch.ones((n, v), device=x.device)
        mask = torch.cat([attention_mask.float(), visual_mask.float()], dim=1)
        for layer in self.encoder.layer:
            x = encoder_layer(self.cfg, layer, x, mask)
        x = x.float()
        return x, self.pooler(x)


class VisualBertForClassification(nn.Module):
    """pooled -> dropout -> linear ``cls``: (N, num_labels) float32 logits."""

    def __init__(self, cfg: VisualBertConfig = VisualBertConfig()):
        super().__init__()
        self.cfg = cfg
        self.visual_bert = VisualBert(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.cls = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, visual_feats, visual_pos=None, attention_mask=None, visual_mask=None,
                token_type_ids=None) -> torch.Tensor:
        _, pooled = self.visual_bert(input_ids, visual_feats, visual_pos, attention_mask, visual_mask,
                                     token_type_ids)
        return self.cls(self.dropout(pooled))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy over integer labels, float32 log-softmax, averaged."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
