"""Train and eval step builders.

Counterpart of ``vltk_tpu/train/steps.py``. JAX compiles one program of
``value_and_grad`` and the optax update; here the step is eager PyTorch:
forward and backward, the optimizer's step (the clip runs inside it), the
scheduler's step. Metrics come back as tensors on the device, so the caller
decides when to pay for a host sync.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

LossFn = Callable[[nn.Module, Dict[str, Any]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _split(batch: Dict[str, Any], parts: int):
    """The batch's leading dim cut into ``parts`` equal microbatches."""
    lead = {v.shape[0] for v in batch.values() if torch.is_tensor(v)}
    if len(lead) != 1 or next(iter(lead)) % parts:
        raise ValueError(f"accum_steps={parts} must divide the batch's leading dim {sorted(lead)}")
    chunks = {k: v.chunk(parts) if torch.is_tensor(v) else [v] * parts for k, v in batch.items()}
    return [{k: c[i] for k, c in chunks.items()} for i in range(parts)]


def make_train_step(
    model: nn.Module, loss_fn: LossFn, optimizer: torch.optim.Optimizer,
    scheduler=None, accum_steps: int = 1,
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
        for mb in micro:
            loss, aux = loss_fn(model, mb)
            (loss / accum_steps if accum_steps > 1 else loss).backward()
            for k, v in {"loss": loss, **aux}.items():
                v = v.detach()
                total[k] = v if k not in total else total[k] + v
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return total if accum_steps == 1 else {k: v / accum_steps for k, v in total.items()}

    return step


def make_eval_step(model: nn.Module, metric_fn: Callable[[nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]]):
    """``metric_fn(model, batch) -> dict`` -> ``eval_step(batch)`` in eval
    mode without autograd."""

    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            return {k: v.detach() for k, v in metric_fn(model, batch).items()}

    return eval_step
