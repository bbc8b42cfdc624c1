"""JAX (flax) params -> the port's state dicts under reference names.

``jax_frcnn_to_torch`` is the inverse of the reference's
``torch_frcnn_to_jax``: it takes the flax param tree of the JAX package's
FRCNN (nested dicts of arrays) and returns a flat state dict of float32
tensors that ``vltk_tpu_torch.models.FRCNN`` (and the reference torch
module) loads:

  conv   kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
  linear kernel (I, O)         -> weight (O, I)
  embed  embedding (V, D)      -> weight (V, D)
  frozen norm scale/bias/mean/var -> weight/bias/running_mean/running_var

The backbone and RoI-head convs sit inside a ``conv`` child in flax
(ConvNorm); the RPN head's convs are plain ``nn.Conv`` leaves.

``jax_layoutlm_to_torch`` is the inverse of the reference's
``torch_layoutlm_to_jax``: flax LayoutLM params (the bare encoder, or a
token-classification / span-QA model with its ``layoutlm`` child) -> the HF
``transformers`` LayoutLM names the port's modules carry (no pooler: the
flax model has none).

``jax_quant_to_torch`` maps a flax ``"quant"`` collection (the int8
layers' recorded ``act_max``) of an FRCNN, LXMERT, LayoutLM or ViT to
``{module name: act_max}`` for ``models.layers.load_int8_scales``.

``jax_vit_to_torch`` and ``jax_visualbert_to_torch`` give HF ``ViTModel`` and
``VisualBertModel`` names (a headed VisualBERT tree: ``visual_bert.`` and
HF ``VisualBertForVisualReasoning``'s ``cls``), the keys the JAX package's
converters of the same names write.

MoE layers (``moe_experts > 0``) have no HF names; the port's are
``models/moe.py``'s: flax ``.../ffn/{router,wi,bi,wo,bo,ln}`` ->
``....moe.{router.weight/bias,wi,bi,wo,bo,LayerNorm.weight/bias}`` (in
LXMERT's cross layers ``lang_ffn`` / ``visn_ffn`` -> ``lang_moe`` /
``visn_moe``); the expert stacks keep flax's (E, in, out) layout.

``jax_lxmert_to_torch`` does the same for LXMERT (an ``LxmertForVQA`` or
``LxmertForPretraining`` tree with its ``lxmert`` child and heads, or a bare
``Lxmert``): HF ``LxmertForQuestionAnswering`` / ``LxmertForPreTraining`` names, the same keys the JAX package's own
``jax_lxmert_to_torch`` writes (its pair table kept here as a copy).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PREFIX = {
    "backbone": "backbone.",
    "rpn_head": "proposal_generator.rpn_head.",
    "roi_heads": "roi_heads.",
}

_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def jax_frcnn_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FRCNN ``params`` -> reference-named torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        top, *mods, leaf = path
        if top not in _PREFIX:
            raise KeyError(f"unexpected FRCNN param path {'/'.join(path)}")
        arr = np.asarray(value, dtype=np.float32)
        if mods and mods[-1] == "norm":
            name, arr_t = ".".join(mods + [_NORM_LEAF[leaf]]), arr
        elif leaf == "kernel" and arr.ndim == 4:
            if top != "rpn_head" and mods and mods[-1] == "conv":
                mods = mods[:-1]  # ConvNorm's inner nn.Conv
            name, arr_t = ".".join(mods + ["weight"]), arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            name, arr_t = ".".join(mods + ["weight"]), arr.T
        elif leaf == "embedding":
            name, arr_t = ".".join(mods + ["weight"]), arr
        elif leaf == "bias":
            name, arr_t = ".".join(mods + ["bias"]), arr
        else:
            raise KeyError(f"unexpected FRCNN param leaf {'/'.join(path)}")
        out[_PREFIX[top] + name] = _tensor(arr_t)
    return out


def _attention_names(flax: str, qkv: str, out: str) -> Dict[tuple, str]:
    return {
        (flax, "query"): f"{qkv}.query",
        (flax, "key"): f"{qkv}.key",
        (flax, "value"): f"{qkv}.value",
        (flax, "att_out"): f"{out}.dense",
        (flax, "ln"): f"{out}.LayerNorm",
    }


def _ffn_names(flax: str, inter: str, out: str, moe: str, is_moe: bool) -> Dict[tuple, str]:
    """A feed-forward's flax module paths -> the port's: HF's dense
    ``inter`` / ``out``, or the port's MoE block ``moe`` (its expert
    stacks are leaves of the block itself)."""
    if is_moe:
        return {(flax,): moe, (flax, "router"): f"{moe}.router", (flax, "ln"): f"{moe}.LayerNorm"}
    return {
        (flax, "intermediate"): f"{inter}.dense",
        (flax, "mlp_out"): f"{out}.dense",
        (flax, "ln"): f"{out}.LayerNorm",
    }


def _bert_layer(is_moe: bool) -> Dict[tuple, str]:
    """flax module path inside a BERT-style layer (LayoutLM's, VisualBERT's,
    LXMERT's language and visual layers) -> HF module path."""
    return {
        **_attention_names("att", "attention.self", "attention.output"),
        **_ffn_names("ffn", "intermediate", "output", "moe", is_moe),
    }


_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight",
         **{w: w for w in ("wi", "bi", "wo", "bo")}}
_HEADS = ("classifier", "qa_outputs")


def _is_moe(tree: Mapping[str, Any]) -> bool:
    return any(path[-1] == "wi" for path, _ in _flatten(tree))


def _bert_name(path, is_moe: bool = False) -> str:
    """flax path inside a single-stream encoder (``embeddings/...``,
    ``layer_i/...`` or ``pooler/dense/...``) -> HF name without the model's
    prefix."""
    top, *mods, leaf = path
    layer = _bert_layer(is_moe)
    if top == "embeddings":
        mod = "LayerNorm" if mods == ["ln"] else ".".join(mods)
        return f"embeddings.{mod}.{_LEAF[leaf]}"
    if top == "pooler" and mods == ["dense"]:
        return f"pooler.dense.{_LEAF[leaf]}"
    if top.startswith("layer_") and tuple(mods) in layer:
        i = int(top[len("layer_"):])
        return f"encoder.layer.{i}.{layer[tuple(mods)]}.{_LEAF[leaf]}"
    raise KeyError(f"unexpected encoder param path {'/'.join(path)}")


def _bert_state_dict(encoder: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    is_moe = _is_moe(encoder)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(encoder):
        arr = np.asarray(value, dtype=np.float32)
        out[prefix + _bert_name(path, is_moe)] = _tensor(arr.T if path[-1] == "kernel" else arr)
    return out


def jax_layoutlm_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LayoutLM params -> the port's (HF-named) state dict of float32
    tensors. A tree with a ``layoutlm`` child (``LayoutLMForTokenClassification``
    / ``LayoutLMForSpanQA``) gives ``layoutlm.``-prefixed encoder names plus
    its ``classifier`` / ``qa_outputs`` head; a bare encoder tree gives
    unprefixed names (``LayoutLM``)."""
    headed = "layoutlm" in params
    out = _bert_state_dict(params["layoutlm"] if headed else params, "layoutlm." if headed else "")
    for head in _HEADS:
        if head in params:
            out[f"{head}.weight"] = _tensor(np.asarray(params[head]["kernel"]).T)
            out[f"{head}.bias"] = _tensor(params[head]["bias"])
    unknown = set(params) - {"layoutlm", *_HEADS} if headed else set()
    if unknown:
        raise KeyError(f"unexpected LayoutLM param keys {sorted(unknown)}")
    return out


def _x_layer(is_moe: bool) -> Dict[tuple, str]:
    """LXMERT's cross-modality layer: one cross-attention (HF's ``att``
    child), then per-stream self-attention and feed-forward."""
    return {
        **_attention_names("cross_att", "visual_attention.att", "visual_attention.output"),
        **_attention_names("lang_self_att", "lang_self_att.self", "lang_self_att.output"),
        **_attention_names("visn_self_att", "visn_self_att.self", "visn_self_att.output"),
        **_ffn_names("lang_ffn", "lang_inter", "lang_output", "lang_moe", is_moe),
        **_ffn_names("visn_ffn", "visn_inter", "visn_output", "visn_moe", is_moe),
    }


_LXMERT_MODULES = {
    ("embeddings", "word_embeddings"): "embeddings.word_embeddings",
    ("embeddings", "position_embeddings"): "embeddings.position_embeddings",
    ("embeddings", "token_type_embeddings"): "embeddings.token_type_embeddings",
    ("embeddings", "ln"): "embeddings.LayerNorm",
    ("visn_fc", "visn_fc"): "encoder.visn_fc.visn_fc",
    ("visn_fc", "visn_ln"): "encoder.visn_fc.visn_layer_norm",
    ("visn_fc", "box_fc"): "encoder.visn_fc.box_fc",
    ("visn_fc", "box_ln"): "encoder.visn_fc.box_layer_norm",
    ("pooler", "dense"): "pooler.dense",
}
# flax layer-name prefix -> (HF stack, layer table)
_LXMERT_STACKS = {
    "layer_": ("encoder.layer", _bert_layer),
    "r_layer_": ("encoder.r_layers", _bert_layer),
    "x_layer_": ("encoder.x_layers", _x_layer),
}
# flax head module path -> HF module path (``LxmertForQuestionAnswering``'s
# answer head, ``LxmertForPreTraining``'s ``cls`` and ``obj_predict_head``)
_LXMERT_HEADS = {
    ("answer_head", "fc"): "answer_head.logit_fc.0",
    ("answer_head", "ln"): "answer_head.logit_fc.2",
    ("answer_head", "logit"): "answer_head.logit_fc.3",
    ("mlm_head", "transform"): "cls.predictions.transform.dense",
    ("mlm_head", "ln"): "cls.predictions.transform.LayerNorm",
    ("mlm_head", "decoder"): "cls.predictions.decoder",
    ("matched_head",): "cls.seq_relationship",
    ("visual_head", "transform"): "obj_predict_head.transform.dense",
    ("visual_head", "ln"): "obj_predict_head.transform.LayerNorm",
    ("visual_head", "obj"): "obj_predict_head.decoder_dict.obj",
    ("visual_head", "attr"): "obj_predict_head.decoder_dict.attr",
    ("visual_head", "feat"): "obj_predict_head.decoder_dict.feat",
}
_HEAD_ROOTS = {mods[0] for mods in _LXMERT_HEADS}


def _lxmert_name(path, is_moe: bool = False) -> str:
    """flax path inside the encoder -> HF name without ``lxmert.``."""
    top, *mods, leaf = path
    module = _LXMERT_MODULES.get((top, *mods))
    for prefix, (stack, layer) in _LXMERT_STACKS.items():
        index, table = top[len(prefix):], layer(is_moe)
        if module is None and top.startswith(prefix) and index.isdigit() and tuple(mods) in table:
            module = f"{stack}.{int(index)}.{table[tuple(mods)]}"
    if module is None or leaf not in _LEAF:
        raise KeyError(f"unexpected LXMERT param path {'/'.join(path)}")
    return f"{module}.{_LEAF[leaf]}"


def _lxmert_head_name(path) -> str:
    """flax path of a head leaf -> HF name. HF keeps the LM decoder's bias
    at ``cls.predictions.bias``."""
    *mods, leaf = path
    module = _LXMERT_HEADS.get(tuple(mods))
    if module is None or leaf not in _LEAF:
        raise KeyError(f"unexpected LXMERT param path {'/'.join(path)}")
    if module == "cls.predictions.decoder" and leaf == "bias":
        return "cls.predictions.bias"
    return f"{module}.{_LEAF[leaf]}"


def jax_lxmert_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LXMERT params -> the port's (HF-named) state dict of float32
    tensors. An ``LxmertForVQA`` or ``LxmertForPretraining`` tree gives
    ``lxmert.``-prefixed encoder names plus its heads (``answer_head.logit_fc.*``;
    ``cls.predictions.*``, ``cls.seq_relationship.*``, ``obj_predict_head.*``);
    a bare ``Lxmert`` tree gives unprefixed names. Any other key raises
    ``KeyError``."""
    headed = "lxmert" in params
    unknown = set(params) - {"lxmert", *_HEAD_ROOTS} if headed else set()
    if unknown:
        raise KeyError(f"unexpected LXMERT param keys {sorted(unknown)}")
    encoder = params["lxmert"] if headed else params
    is_moe = _is_moe(encoder)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(encoder):
        arr = np.asarray(value, dtype=np.float32)
        out[("lxmert." if headed else "") + _lxmert_name(path, is_moe)] = _tensor(
            arr.T if path[-1] == "kernel" else arr)
    for root in sorted(set(params) & _HEAD_ROOTS) if headed else ():
        for path, value in _flatten(params[root], (root,)):
            arr = np.asarray(value, dtype=np.float32)
            out[_lxmert_head_name(path)] = _tensor(arr.T if path[-1] == "kernel" else arr)
    return out


def _quant_module(path, kind: str) -> str:
    """flax path of an int8 layer (without ``act_max``) -> the port's module
    name: the ConvNorm of an FRCNN ``.../conv`` path, the HF-named
    projection of an LXMERT, LayoutLM or ViT path."""
    if kind == "frcnn":
        top, *mods = path
        if top not in _PREFIX or not mods or mods[-1] != "conv":
            raise KeyError(f"unexpected FRCNN quant path {'/'.join(path)}")
        return _PREFIX[top] + ".".join(mods[:-1])
    if kind == "vit":
        return _vit_name((*path, "kernel"))[: -len(".weight")]
    headed = path[0] == kind
    rest = tuple(path[1:]) if headed else tuple(path)
    name = (_lxmert_name if kind == "lxmert" else _bert_name)((*rest, "kernel"))
    return (f"{kind}." if headed else "") + name[: -len(".weight")]


def jax_quant_to_torch(quant: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """A flax ``"quant"`` collection (nested dicts of arrays, each int8
    layer's ``act_max``) -> ``{module name: act_max}`` of ``model``, the
    port's ``FRCNN``, an LXMERT model, a LayoutLM model or a ``ViT``. Every name must be
    one of ``model``'s int8 layers."""
    from vltk_tpu_torch.models.frcnn import FRCNN
    from vltk_tpu_torch.models.layers import int8_layers
    from vltk_tpu_torch.models.vit import ViT

    kind = "frcnn" if isinstance(model, FRCNN) else "vit" if isinstance(model, ViT) else (
        "layoutlm" if type(model).__name__.startswith("LayoutLM") else "lxmert")
    layers = int8_layers(model)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(quant):
        if path[-1] != "act_max":
            raise KeyError(f"unexpected quant leaf {'/'.join(path)}")
        name = _quant_module(path[:-1], kind)
        if name not in layers:
            raise KeyError(f"{'/'.join(path)} -> {name}, which is no int8 layer of the model")
        out[name] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


# flax module inside ``layer_i_att`` / ``layer_i_mlp`` -> HF ``ViTLayer`` module
_VIT_ATT = {
    ("ln_before",): "layernorm_before",
    ("query",): "attention.attention.query",
    ("key",): "attention.attention.key",
    ("value",): "attention.attention.value",
    ("att_out",): "attention.output.dense",
}
_VIT_MLP = {
    ("ln_after",): "layernorm_after",
    ("intermediate",): "intermediate.dense",
    ("mlp_out",): "output.dense",
}
_VIT_TOP = {
    ("ln",): "layernorm",
    ("pooler",): "pooler.dense",
    ("patch_embed",): "embeddings.patch_embeddings.projection",
}


def _vit_name(path) -> str:
    """flax ViT path -> HF ``ViTModel`` name."""
    top, *mods, leaf = path
    module = _VIT_TOP.get((top, *mods))
    for suffix, table in (("_att", _VIT_ATT), ("_mlp", _VIT_MLP)):
        index = top[len("layer_"):-len(suffix)]
        if module is None and top.startswith("layer_") and top.endswith(suffix) and index.isdigit() \
                and tuple(mods) in table:
            module = f"encoder.layer.{int(index)}.{table[tuple(mods)]}"
    if module is None or leaf not in _LEAF:
        raise KeyError(f"unexpected ViT param path {'/'.join(path)}")
    return f"{module}.{_LEAF[leaf]}"


def jax_vit_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ViT params -> the port's (HF ``ViTModel``-named) state dict of
    float32 tensors: the patch kernel HWIO -> OIHW, dense kernels
    transposed, the CLS token and the position table as they are."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        if path in (("cls_token",), ("position_embeddings",)):
            out[f"embeddings.{path[0]}"] = _tensor(arr)
            continue
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[_vit_name(path)] = _tensor(arr)
    return out


def jax_visualbert_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax VisualBERT params -> the port's (HF-named) state dict of float32
    tensors. A ``VisualBertForClassification`` tree (``visualbert`` and
    ``classifier`` children) gives ``visual_bert.``-prefixed encoder names
    and HF ``VisualBertForVisualReasoning``'s ``cls`` head; a bare
    ``VisualBert`` tree gives ``VisualBertModel`` names."""
    headed = "visualbert" in params
    unknown = set(params) - {"visualbert", "classifier"} if headed else set()
    if unknown:
        raise KeyError(f"unexpected VisualBERT param keys {sorted(unknown)}")
    out = _bert_state_dict(params["visualbert"] if headed else params, "visual_bert." if headed else "")
    if headed:
        out["cls.weight"] = _tensor(np.asarray(params["classifier"]["kernel"]).T)
        out["cls.bias"] = _tensor(params["classifier"]["bias"])
    return out
