"""Path-rule parameter shardings (tensor parallelism) and ZeRO-1 layouts.

Counterpart of ``vltk_tpu/parallel/sharding.py``. A rule set is a
sequence of ``(name_regex, PartitionSpec)`` pairs matched (``re.match``,
first match wins) against the port's state-dict names, which keep HF's
(``encoder.layer.0.attention.self.query.weight``); unmatched parameters
replicate. ``nn.Linear.weight`` is (out, in), the transpose of a flax
kernel, so a column-parallel projection shards weight dim 0 and a
row-parallel one dim 1: ``LXMERT_RULES`` is the JAX table transposed.

``shard_params`` cuts every parameter to this rank's block in place and
tells the layers the port runs tensor-parallel (the encoders' projections
and the word embeddings of LXMERT, LayoutLM and VisualBERT) and the MoE
blocks whose expert stacks it cuts how they are cut; a rule that reaches
any other layer raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple, Union

import torch
from torch import nn

from vltk_tpu_torch.parallel.mesh import Mesh, NamedSharding, P, PartitionSpec

Rules = Sequence[Tuple[str, PartitionSpec]]

# Megatron-style TP of the LXMERT-style encoders over the ``model`` axis,
# in the JAX table's order: q/k/v and the MLP up-projection split their
# output features, the attention output and MLP down-projection their
# input features (one all-reduce after each), the word table its rows
LXMERT_RULES: Rules = (
    # column-parallel: split output features (weight dim 0)
    (r".*\.(query|key|value)\.weight$", P("model", None)),
    (r".*\.(query|key|value)\.bias$", P("model")),
    (r".*(intermediate|_inter)\.dense\.weight$", P("model", None)),
    (r".*(intermediate|_inter)\.dense\.bias$", P("model")),
    # row-parallel: split input features (weight dim 1), all-reduce after
    (r".*(attention|_att)\.output\.dense\.weight$", P(None, "model")),
    (r".*output\.dense\.weight$", P(None, "model")),
    # embeddings: vocab rows over the model axis
    (r".*word_embeddings\.weight$", P("model", None)),
)

# the JAX package's expert-parallel table on the port's MoE names (the
# stacks keep flax's (E, h, f) / (E, f, h) layout): each rank holds E/ep
# experts, each column/row-cut over ``model``; the router replicates
LXMERT_MOE_RULES: Rules = (
    (r".*moe\.wi$", P("expert", None, "model")),
    (r".*moe\.bi$", P("expert", "model")),
    (r".*moe\.wo$", P("expert", "model", None)),
    (r".*moe\.bo$", P("expert", None)),
) + tuple(LXMERT_RULES)


def _spec_for(name: str, shape, rules: Rules) -> PartitionSpec:
    for pattern, spec in rules:
        if re.match(pattern, name):
            if len(spec) > len(shape):  # drop trailing axes the tensor lacks
                spec = P(*spec[: len(shape)])
            return spec
    return P()


def _fit_spec(spec: PartitionSpec, shape, mesh: Mesh) -> PartitionSpec:
    """JAX's per-dim fallback: a dim whose axes the mesh lacks, or whose
    size the axes do not divide, replicates; the other dims keep theirs."""
    entries = []
    for dim, axis in enumerate(spec):
        if axis is None:
            entries.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        kept = tuple(a for a in axes if a in mesh.shape)
        size = 1
        for a in kept:
            size *= mesh.shape[a]
        if not kept or dim >= len(shape) or shape[dim] % size != 0:
            entries.append(None)
        else:
            entries.append(kept if len(kept) > 1 else kept[0])
    if tuple(entries) == tuple(spec):
        return spec
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _global_shapes(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Tuple[int, ...]]:
    """name -> global shape: a sharded model's recorded shapes, else the
    tensors' own."""
    if isinstance(params, nn.Module):
        recorded = getattr(params, "_vltk_global_shapes", None)
        if recorded is not None:
            return dict(recorded)
        params = dict(params.named_parameters())
    return {k: tuple(v.shape) for k, v in params.items()}


def infer_shardings(params, rules: Rules, mesh: Mesh) -> Dict[str, NamedSharding]:
    """name -> ``NamedSharding`` of every parameter of a module (or entry
    of a state dict), from ``rules`` fitted to ``mesh``."""
    return {name: NamedSharding(mesh, _fit_spec(_spec_for(name, shape, rules), shape, mesh))
            for name, shape in _global_shapes(params).items()}


def _add_axis_to_spec(spec: PartitionSpec, shape, mesh: Mesh, axis: str) -> PartitionSpec:
    """``axis`` on the first free dim it divides (ZeRO sharding of an
    optimizer moment on top of its parameter's TP spec)."""
    if axis not in mesh.shape:
        return spec
    size = mesh.shape[axis]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, used in enumerate(entries):
        if used is not None:
            continue
        if shape[dim] % size == 0 and shape[dim] > 0:
            entries[dim] = axis
            return P(*entries)
    return spec


def linear_weights(params) -> set:
    """Names of the (out, in) ``nn.Linear`` weights, the transposes of flax
    kernels: a module's, or in a state dict the 2-D ``*.weight`` entries
    that are not embedding tables (``*embeddings.weight``)."""
    if isinstance(params, nn.Module):
        return {f"{n}.weight" if n else "weight" for n, m in params.named_modules() if isinstance(m, nn.Linear)}
    return {k for k, v in params.items() if k.endswith(".weight") and len(v.shape) == 2
            and not k.endswith("embeddings.weight")}


def moment_spec(spec: PartitionSpec, shape, mesh: Mesh, axis: str, transposed: bool) -> PartitionSpec:
    """The ZeRO-1 spec of a parameter's moment: ``_add_axis_to_spec`` in
    the JAX package's orientation, so an ``nn.Linear`` weight takes the
    axis on the dim that is first in the flax kernel (its input features,
    dim 1 here) and the blocks are JAX's."""
    if not transposed:
        return _add_axis_to_spec(spec, shape, mesh, axis)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    flipped = _add_axis_to_spec(P(*padded[::-1]), tuple(shape)[::-1], mesh, axis)
    out = tuple(flipped) + (None,) * (len(shape) - len(flipped))
    return spec if tuple(flipped) == padded[::-1] else P(*out[::-1])


def zero1_state_shardings(params, rules: Rules, mesh: Mesh, axis: str = "data") -> Dict[str, Dict[str, NamedSharding]]:
    """ZeRO-1 layout (DeepSpeed ZeRO stage 1): parameters keep their TP
    shardings; each AdamW moment (``exp_avg``, ``exp_avg_sq``; optax's
    ``mu``, ``nu``) is also cut over ``axis`` on its first free dim that
    the axis divides, counted in the flax kernel's order (``moment_spec``).
    -> {"params" | "exp_avg" | "exp_avg_sq": {name: NamedSharding}}."""
    base = infer_shardings(params, rules, mesh)
    shapes = _global_shapes(params)
    flipped = linear_weights(params)
    moments = {name: NamedSharding(mesh, moment_spec(s.spec, shapes[name], mesh, axis, name in flipped))
               for name, s in base.items()}
    return {"params": base, "exp_avg": moments, "exp_avg_sq": dict(moments)}


def _tp_groups(model: nn.Module):
    """The layers the port can run tensor-parallel, as groups that are cut
    together or not at all: each attention's q, k, v (column) and output
    (row), each feed-forward's intermediate (column) and output (row),
    each word table (vocab rows). -> [(kind, [(module path, role, module)],
    head_dim)]."""
    from vltk_tpu_torch.models.lxmert import _FFN, _LANG_FFN, _VISN_FFN, MultiHeadAttention, _DenseNorm, _Intermediate

    groups = []
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, MultiHeadAttention):
            qkv = getattr(mod, mod.qkv_name)
            members = [(f"{pre}{mod.qkv_name}.{part}", "column", getattr(qkv, part))
                       for part in ("query", "key", "value")]
            groups.append(("attention", members + [(f"{pre}output.dense", "row", mod.output.dense)],
                           mod.cfg.head_dim))
        for inter, out, _ in (_FFN, _LANG_FFN, _VISN_FFN):
            i_mod, o_mod = getattr(mod, inter, None), getattr(mod, out, None)
            if isinstance(i_mod, _Intermediate) and isinstance(o_mod, _DenseNorm):
                groups.append(("ffn", [(f"{pre}{inter}.dense", "column", i_mod.dense),
                                       (f"{pre}{out}.dense", "row", o_mod.dense)], 0))
        if isinstance(getattr(mod, "word_embeddings", None), nn.Embedding):
            groups.append(("vocab", [(f"{pre}word_embeddings", "vocab", mod.word_embeddings)], 0))
    return groups


#: an MoE block's expert stacks -> the spec each dim may take (or None)
_EXPERT_SPECS = {"wi": P("expert", None, "model"), "bi": P("expert", "model"),
                 "wo": P("expert", "model", None), "bo": P("expert", None)}


def _expert_layouts(model: nn.Module, shardings, mesh: Mesh):
    """-> ({stack name: its allowed spec}, [(MoE block, ExpertLayout)]) for
    every MoE block whose stacks the rules cut. The four stacks of a block
    must agree: all or none cut over ``expert``, and ``wi``, ``bi`` and
    ``wo`` all or none over ``model``."""
    from vltk_tpu_torch.models.moe import ExpertLayout, MoEFeedForward

    allowed, layouts = {}, []
    for mname, mod in model.named_modules():
        if not isinstance(mod, MoEFeedForward):
            continue
        pre = f"{mname}." if mname else ""
        specs = {}
        for stack, spec in _EXPERT_SPECS.items():
            allowed[f"{pre}{stack}"] = spec
            specs[stack] = _padded(shardings[f"{pre}{stack}"].spec, len(spec))
        expert = {specs[k][0] == "expert" for k in _EXPERT_SPECS}
        model_dims = {specs["wi"][2] == "model", specs["bi"][1] == "model", specs["wo"][1] == "model"}
        if len(expert) > 1 or len(model_dims) > 1:
            raise NotImplementedError(f"the rules cut the expert stacks of {mname} unevenly: {specs}")
        if expert.pop() or model_dims.pop():
            layouts.append((mod, ExpertLayout(mesh, specs["wi"][0] == "expert", specs["wi"][2] == "model")))
    return allowed, layouts


_ROLE_SPECS = {  # role -> (weight spec, bias spec)
    "column": (P("model", None), P("model")),
    "row": (P(None, "model"), P()),
    "vocab": (P("model", None), P()),
}


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _cut(spec) -> bool:
    return any(e is not None for e in spec)


def shard_params(model: nn.Module, rules: Rules, mesh: Mesh) -> nn.Module:
    """Cut every parameter of ``model`` (global values, the same on every
    rank) to this rank's block under ``rules`` in place, and mark the
    tensor-parallel layers (``module.tp = (role, mesh)``, role "column",
    "row" or "vocab") and the MoE blocks whose expert stacks are cut
    (``module.ep``, a ``models.moe.ExpertLayout``) for their forwards.
    Raises ``NotImplementedError`` where a rule cuts a parameter the port
    runs only replicated, cuts part of an attention or feed-forward group
    or of a block's expert stacks, or splits an attention head."""
    shardings = infer_shardings(model, rules, mesh)
    shapes = _global_shapes(model)
    groups = _tp_groups(model)
    expected = {}
    for _, members, _ in groups:
        for path, role, _ in members:
            expected[f"{path}.weight"], expected[f"{path}.bias"] = _ROLE_SPECS[role]
    experts, layouts = _expert_layouts(model, shardings, mesh)
    for name, sharding in shardings.items():
        n = len(shapes[name])
        got = _padded(sharding.spec, n)
        if name in experts:  # each dim its axis or, where the fit dropped it, none
            if any(g is not None and g != w for g, w in zip(got, _padded(experts[name], n))):
                raise NotImplementedError(f"the rules cut {name} as {sharding.spec}; the port runs it "
                                          f"only within {experts[name]}")
        elif _cut(sharding.spec) and got != _padded(expected.get(name, P()), n):
            raise NotImplementedError(
                f"the rules cut {name} as {sharding.spec}; the port runs it only so: {expected.get(name, P())}")
    tp = mesh.axis_size("model")
    marked = []
    for kind, members, head_dim in groups:
        cut = [_cut(shardings[f"{path}.weight"].spec) for path, _, _ in members]
        if not any(cut):
            continue
        if not all(cut):
            raise NotImplementedError(f"the rules cut only part of {[m[0] for m in members]}")
        if kind == "attention" and (shapes[f"{members[0][0]}.weight"][0] // tp) % head_dim:
            heads = shapes[f"{members[0][0]}.weight"][0] // head_dim
            raise NotImplementedError(f"{members[0][0]}: {heads} heads do not split over a model axis of {tp}")
        marked += [(role, module) for _, role, module in members]
    params = dict(model.named_parameters())
    for name, sharding in shardings.items():
        if _cut(sharding.spec):
            params[name].data = sharding.local(params[name].data).clone()
    for role, module in marked:
        module.tp = (role, mesh)
    for module, layout in layouts:
        module.ep = layout
    model._vltk_global_shapes = shapes
    model._vltk_shardings = shardings
    return model
