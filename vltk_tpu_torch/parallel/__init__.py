"""Parallelism of the port: a named mesh over ``torch.distributed``,
tensor-parallel rules, ZeRO-1 layouts, Ulysses and ring attention, GPipe
and expert parallelism.

Counterpart of ``vltk_tpu/parallel/``. JAX declares shardings and XLA
inserts the collectives; here each rank is a process that holds its own
blocks and calls the collectives itself (``collectives.py``, counted in
``collectives.COUNTS``). The axes:

  * ``data``: batch-sharded (DP); gradients are summed over ``data`` x
    ``seq`` and divided by their size (``collectives.reduce_gradients``).
  * ``model``: tensor parallel (TP), Megatron's column-then-row split of
    every attention and feed-forward, vocab-sharded word tables.
  * ``seq``: sequence parallel (SP) for long token streams: the stream is
    cut between the embeddings and the pooler; Ulysses or ring attention.
  * ``expert``: expert parallel (EP): an MoE block's expert stacks cut
    over the axis (``LXMERT_MOE_RULES``, ``models/moe.py``), the tokens
    routed as the global batch's.
  * ``pipe``: pipeline parallel (PP): ``gpipe_spmd`` over a stack of
    layers (``stack_layer_params``), microbatches handed from stage to
    stage. Outside ``gpipe_spmd`` the ``pipe`` ranks, like the ``expert``
    ranks, hold the same tokens: replicas whose gradients are not summed.
"""

from vltk_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    batch_sharding,
    current_mesh,
    make_mesh,
    replicated,
    shard_batch,
    use_mesh,
)
from vltk_tpu_torch.parallel.pipeline import gpipe_spmd, stack_layer_params
from vltk_tpu_torch.parallel.ring import ring_self_attention
from vltk_tpu_torch.parallel.sharding import (
    LXMERT_MOE_RULES,
    LXMERT_RULES,
    infer_shardings,
    shard_params,
    zero1_state_shardings,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "make_mesh",
    "current_mesh",
    "use_mesh",
    "ring_self_attention",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "infer_shardings",
    "shard_params",
    "zero1_state_shardings",
    "gpipe_spmd",
    "stack_layer_params",
    "LXMERT_RULES",
    "LXMERT_MOE_RULES",
]
