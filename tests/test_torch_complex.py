"""The rest of the port's train layer on the CPU: ``ComplexExperiment``
held against the JAX package's, and ``remat`` on the transformer encoders.

* ``ComplexExperiment``: JAX's two-train-loop, one-eval-loop experiment of
  ``tests/test_aux.py`` and its port twin, on one linear model with the
  same initial weights and the same batches: the loops run in declaration
  order every epoch, each step's record and loss equal JAX's (rtol 1e-5:
  float32, torch's AdamW and optax round the same update at other places),
  and the schedule is rebuilt over the true steps an epoch.
* ``remat``: LXMERT, LayoutLM and VisualBERT with ``remat=True`` (every
  encoder layer checkpointed) give the plain run's loss and gradients with
  dropout on, since the recompute replays the saved RNG state.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn
import jax.numpy as jnp
import torch
from torch import nn

from vltk_tpu.config import Config as JConfig
from vltk_tpu.train.complex import ComplexExperiment as JComplex
from vltk_tpu.train.complex import Loop as JLoop

from vltk_tpu_torch.config import Config
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, token_classification_loss
from vltk_tpu_torch.models.lxmert import LxmertConfig, LxmertForVQA, init_weights, vqa_soft_loss
from vltk_tpu_torch.models.visualbert import VisualBertConfig, VisualBertForClassification, classification_loss
from vltk_tpu_torch.train import ComplexExperiment, Loop


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


class JaxTwoLoop(JComplex):
    """``tests/test_aux.py``'s ``_TwoLoop``."""

    name = "twoloop"

    def build_model(self):
        model = fnn.Dense(1)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
        return model.apply, params

    def loss_fn(self, params, batch, rng):
        pred = self.apply_fn({"params": params}, batch["x"])[:, 0]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    def aux_loss(self, params, batch, rng):
        pred = self.apply_fn({"params": params}, batch["x"])[:, 0]
        return jnp.mean(jnp.abs(pred - batch["y"])), {}

    def eval_metrics(self, params, batch):
        pred = self.apply_fn({"params": params}, batch["x"])[:, 0]
        return {"mse": jnp.mean((pred - batch["y"]) ** 2)}

    def loops(self):
        return [
            JLoop("main", self._main_loader, train=True),
            JLoop("aux", self._aux_loader, train=True, loss_fn=self.aux_loss),
            JLoop.eval_instance("val", self._val_loader),
        ]


class TwoLoop(ComplexExperiment):
    """The port twin: ``nn.Linear(3, 1)`` with the flax Dense's weights."""

    name = "twoloop"
    weights = None  # (kernel (3, 1), bias (1,)) of the JAX model

    def build_model(self):
        lin = nn.Linear(3, 1)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np.array(self.weights[0]).T))
            lin.bias.copy_(torch.from_numpy(np.array(self.weights[1])))
        return lin

    def loss_fn(self, model, batch):
        return torch.mean((model(batch["x"])[:, 0] - batch["y"]) ** 2), {}

    def aux_loss(self, model, batch):
        return torch.mean(torch.abs(model(batch["x"])[:, 0] - batch["y"])), {}

    def eval_metrics(self, model, batch):
        return {"mse": torch.mean((model(batch["x"])[:, 0] - batch["y"]) ** 2)}

    def loops(self):
        return [
            Loop("main", self._main_loader, train=True),
            Loop("aux", self._aux_loader, train=True, loss_fn=self.aux_loss),
            Loop.eval_instance("val", self._val_loader),
        ]


def two_loop_batches(seed):
    rng = np.random.default_rng(seed)
    w = np.array([1.0, -1.0, 2.0], np.float32)

    def mk(n, bs=8):
        out = []
        for _ in range(n):
            x = rng.normal(size=(bs, 3)).astype(np.float32)
            out.append({"x": x, "y": x @ w})
        return out

    return mk(3), mk(2), mk(1)


def run(exp, batches):
    exp._main_loader, exp._aux_loader, exp._val_loader = (ListLoader(b) for b in batches)
    result = exp()
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return result, [json.loads(line) for line in f]


def test_complex_experiment_matches_jax(tmp_path):
    """Two train loops and one eval loop, two epochs: the same result keys,
    loops in order, steps numbered across loops, losses and the eval
    metric equal to JAX's; the optimizer rebuilt over 10 steps, each
    loop's step on it; the shared model trains (the main loss falls)."""
    batches = two_loop_batches(0)
    jcfg = JConfig()
    jcfg.logdir = str(tmp_path / "jax")
    jcfg.train.update({"epochs": 2, "learning_rate": 0.1})
    jexp = JaxTwoLoop(jcfg)
    jresult, jrecords = run(jexp, batches)

    cfg = Config()
    cfg.logdir = str(tmp_path / "port")
    cfg.train.update({"epochs": 2, "learning_rate": 0.1})
    jinit = jax.tree_util.tree_map(np.asarray, JaxTwoLoop.build_model(jexp)[1])
    TwoLoop.weights = (jinit["kernel"], jinit["bias"])
    exp = TwoLoop(cfg, device="cpu")
    result, records = run(exp, batches)

    assert set(result) == set(jresult) == {"epoch", "main", "aux", "val"}
    assert exp.total_steps == jexp.total_steps == 10
    assert [(r["loop"], r["epoch"], r["step"]) for r in records] == [
        (r["loop"], r["epoch"], r["step"]) for r in jrecords]
    assert [r["loop"] for r in records[:5]] == ["main"] * 3 + ["aux"] * 2
    np.testing.assert_allclose([r["loss"] for r in records], [r["loss"] for r in jrecords], rtol=1e-5)
    np.testing.assert_allclose(result["val"]["mse"], jresult["val"]["mse"], rtol=1e-5)
    main = [r["loss"] for r in records if r["loop"] == "main"]
    assert main[-1] < main[0]
    with open(os.path.join(exp.logdir, "epoch_log.txt")) as f:
        assert f.read().count("val_mse=") == 2


def test_complex_experiment_resume_keeps_the_optimizer_state(tmp_path):
    """A two-epoch run stopped after its first epoch and resumed equals the
    run in one go: the rebuilt optimizer keeps the loaded moments and
    update count, and its lr is the schedule's at that count."""
    batches = two_loop_batches(1)
    TwoLoop.weights = (np.array([[0.1], [0.2], [-0.3]], np.float32), np.array([0.05], np.float32))

    class Stop(Exception):
        pass

    class StopAtEpoch1(ListLoader):
        def set_epoch(self, epoch):
            if epoch == 1:
                raise Stop

    def experiment(logdir):
        cfg = Config()
        cfg.logdir = str(logdir)
        cfg.train.update({"epochs": 2, "learning_rate": 0.1})
        return TwoLoop(cfg, device="cpu")

    straight, _ = run(experiment(tmp_path / "a"), batches)
    first = experiment(tmp_path / "b")
    first._main_loader, first._aux_loader, first._val_loader = (StopAtEpoch1(b) for b in batches)
    with pytest.raises(Stop):
        first()
    resumed_exp = experiment(tmp_path / "b")
    assert resumed_exp.start_epoch == 1 and resumed_exp.global_step == 5
    resumed, records = run(resumed_exp, batches)
    assert [r["epoch"] for r in records] == [0] * 5 + [1] * 5
    for loop in ("main", "aux", "val"):
        for k, v in straight[loop].items():
            assert resumed[loop][k] == pytest.approx(v, rel=1e-6), (loop, k)


# ------------------------------------------------------------------ remat

ENCODER = dict(vocab_size=60, hidden_size=32, num_heads=2, intermediate_size=64, max_position_embeddings=32,
               visual_feat_dim=8, hidden_dropout=0.1, attention_dropout=0.1)


def remat_case(name, remat):
    """(model with seeded weights in train mode, loss of a batch)."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(1, 60, (2, 12)))
    mask = torch.ones(2, 12)
    mask[1, 9:] = 0
    feats = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    pos = torch.from_numpy(np.sort(rng.uniform(0, 1, (2, 4, 2, 2)), axis=2).reshape(2, 4, 4).astype(np.float32))
    if name == "lxmert":
        cfg = LxmertConfig(**ENCODER, l_layers=2, x_layers=2, r_layers=1, num_answers=5, remat=remat)
        model = init_weights(LxmertForVQA(cfg), seed=0)
        target = torch.from_numpy(rng.choice([0.0, 0.3, 1.0], (2, 5)).astype(np.float32))
        return model.train(), lambda m: vqa_soft_loss(m(ids, feats, pos, mask), target)
    if name == "layoutlm":
        cfg = LayoutLMConfig(**ENCODER, l_layers=3, remat=remat)
        model = init_weights(LayoutLMForTokenClassification(cfg), seed=0)
        boxes = torch.from_numpy(np.sort(rng.integers(0, 1000, (2, 12, 2, 2)), axis=2).reshape(2, 12, 4))
        labels = torch.from_numpy(rng.integers(0, 4, (2, 12)))
        labels[1, 9:] = -100
        return model.train(), lambda m: token_classification_loss(m(ids, boxes, mask), labels)
    assert name == "visualbert"
    cfg = VisualBertConfig(**ENCODER, l_layers=3, remat=remat)
    model = init_weights(VisualBertForClassification(cfg), seed=0)
    labels = torch.tensor([0, 1])
    return model.train(), lambda m: classification_loss(m(ids, feats, None, mask), labels)


@pytest.mark.parametrize("name", ["lxmert", "layoutlm", "visualbert"])
def test_remat_matches_the_plain_run(name):
    """Same names, loss and gradients with ``remat`` (dropout on: the
    recompute draws the forward's masks again); without grad ``remat``
    takes the plain path."""
    runs = []
    for remat in (False, True):
        model, loss_fn = remat_case(name, remat)
        torch.manual_seed(7)
        loss = loss_fn(model)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert set(runs[0][1]) == set(runs[1][1])
    for n, g in runs[0][1].items():
        if g is None:
            assert runs[1][1][n] is None, n
            continue
        np.testing.assert_allclose(runs[1][1][n].numpy(), g.numpy(), rtol=1e-6, atol=1e-9, err_msg=n)
    model, loss_fn = remat_case(name, True)
    with torch.no_grad():
        assert loss_fn(model.eval()).grad_fn is None
