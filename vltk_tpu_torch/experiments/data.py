"""The "data" experiment: counterpart of ``vltk_tpu/experiments/data.py``.
Not a training loop: takes one batch of each loader and reports its keys
and shapes."""

from __future__ import annotations

from typing import Any, Dict


class DataExperiment:
    name = "data"

    def __init__(self, config, loaders=None):
        self.config = config
        if loaders is None:
            from vltk_tpu_torch.data.builder import init_datasets

            loaders = init_datasets(config)
        self.train_loader, self.eval_loader = loaders

    def __call__(self) -> Dict[str, Any]:
        report: Dict[str, Any] = {}
        for tag, loader in (("train", self.train_loader), ("eval", self.eval_loader)):
            if loader is None:
                continue
            batch = next(iter(loader))
            report[tag] = {k: getattr(v, "shape", type(v).__name__) for k, v in batch.items()}
            print(f"[{tag}]")
            for k, s in report[tag].items():
                print(f"  {k}: {s}")
        return report
