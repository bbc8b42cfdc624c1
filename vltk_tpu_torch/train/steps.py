"""Train and eval step builders.

Counterpart of ``vltk_tpu/train/steps.py``. JAX compiles one program of
``value_and_grad`` and the optax update; here the step is eager PyTorch:
forward and backward, the optimizer's step (the clip runs inside it), the
scheduler's step. Metrics come back as tensors on the device, so the caller
decides when to pay for a host sync.

Under a mesh the step runs inside ``parallel.use_mesh`` (the models and
the masked losses read it), every gradient is summed over the mesh's
data x seq ranks and divided by their count before the optimizer
(``parallel.collectives.reduce_gradients``, where XLA's partitioner adds
JAX's psum), and the metrics are averaged over the ``data`` axis, so they
are the global batch's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.parallel.mesh import use_mesh

LossFn = Callable[[nn.Module, Dict[str, Any]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _split(batch: Dict[str, Any], parts: int):
    """The batch's leading dim cut into ``parts`` equal microbatches."""
    lead = {v.shape[0] for v in batch.values() if torch.is_tensor(v)}
    if len(lead) != 1 or next(iter(lead)) % parts:
        raise ValueError(f"accum_steps={parts} must divide the batch's leading dim {sorted(lead)}")
    chunks = {k: v.chunk(parts) if torch.is_tensor(v) else [v] * parts for k, v in batch.items()}
    return [{k: c[i] for k, c in chunks.items()} for i in range(parts)]


def _mesh_context(mesh):
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def make_train_step(
    model: nn.Module, loss_fn: LossFn, optimizer: torch.optim.Optimizer,
    scheduler=None, accum_steps: int = 1, mesh=None,
) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``loss_fn(model, batch) -> (loss, aux dict)`` -> ``step(batch) ->
    metrics`` (``loss`` and the aux values, detached tensors).

    ``accum_steps > 1``: the batch's leading dim is split into that many
    microbatches, each one's gradient of ``loss / accum_steps`` is summed
    into ``.grad``, and ONE optimizer update applies the mean gradient; the
    loss and aux metrics are the microbatch means. That is the full-batch
    step whenever the loss is a mean over equally sized microbatches."""
    accum_steps = int(accum_steps)

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.train()
        model.zero_grad(set_to_none=True)  # frozen parameters' too, which the optimizer does not hold
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        total: Dict[str, torch.Tensor] = {}
        with _mesh_context(mesh):
            for mb in micro:
                loss, aux = loss_fn(model, mb)
                (loss / accum_steps if accum_steps > 1 else loss).backward()
                for k, v in {"loss": loss, **aux}.items():
                    v = v.detach()
                    total[k] = v if k not in total else total[k] + v
            if mesh is not None:
                C.reduce_gradients(model.parameters(), mesh)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            out = total if accum_steps == 1 else {k: v / accum_steps for k, v in total.items()}
            return out if mesh is None else C.mean_over_data(out, mesh)

    return step


def make_eval_step(model: nn.Module, metric_fn: Callable[[nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]],
                   mesh=None):
    """``metric_fn(model, batch) -> dict`` -> ``eval_step(batch)`` in eval
    mode without autograd; under ``mesh`` the metrics are averaged over
    its ``data`` axis."""

    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), _mesh_context(mesh):
            out = {k: v.detach() for k, v in metric_fn(model, batch).items()}
            return out if mesh is None else C.mean_over_data(out, mesh)

    return eval_step
