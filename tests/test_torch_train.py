"""The training slice of the PyTorch port held against the JAX package on the
CPU, float32, at tiny size (2 layers, hidden 128, 2 heads of 64, s = 128).

Weights are the JAX package's flax ``init`` params carried across with
``jax_layoutlm_to_torch``; inputs, gradients and batches are made with
numpy from a seed and fed to both packages. Dropout is 0 wherever the two
packages are compared (torch and JAX draw different masks); the resume
tests run inside the port with dropout on. Tolerances:

* the plain flash backward against ``jax.vjp`` of ``_flash_self_attention``
  in Pallas interpret mode: 2e-5 at every position (float32 sums in
  another order);
* losses: 1e-6; optimizer steps: 1e-6 (torch's AdamW and optax round the
  same update at other places; the clip follows optax's rule);
* train steps and the experiment's logged losses: 1e-4 (the model's
  float32 forward differs by ~1e-6, see ``test_torch_layoutlm.py``, and the
  updates carry it);
* resume inside the port: bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu import config as JC
from vltk_tpu.models import layoutlm as JL
from vltk_tpu.models import lxmert as JX
from vltk_tpu.processing import visn as JV
from vltk_tpu.train import optim as JO
from vltk_tpu.train import steps as JS

from vltk_tpu_torch import config as PC
from vltk_tpu_torch.experiments import Experiments, OCRTokenExperiment
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch
from vltk_tpu_torch.models.layoutlm import (
    LayoutLMConfig,
    LayoutLMForTokenClassification,
    span_qa_loss,
    token_classification_loss,
)
from vltk_tpu_torch.models.lxmert import masked_cross_entropy
from vltk_tpu_torch.ops.flash_attention import (
    flash_self_attention,
    flash_self_attention_backward,
    flash_self_attention_fwd_residuals,
)
from vltk_tpu_torch.processing import visn as PV
from vltk_tpu_torch.train import optim as PO
from vltk_tpu_torch.train.steps import make_train_step

TINY = dict(
    vocab_size=100, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
    max_position_embeddings=128, hidden_dropout=0.0, attention_dropout=0.0,
)
S = 128
B = 4


def t(a):
    return torch.from_numpy(np.asarray(a))


def port_cfg(jcfg, **over):
    return dataclasses.replace(LayoutLMConfig(**dataclasses.asdict(jcfg)), **over)


def flat_jax(tree):
    return {k: np.asarray(v) for k, v in tu.flatten_dict(tree, sep="/").items()}


def name_map(params):
    """flax path -> torch name, through the converter: every leaf is filled
    with its index, which survives the transposes."""
    paths = list(tu.flatten_dict(params, sep="/"))
    marked = tu.unflatten_dict(
        {tuple(p.split("/")): np.full(np.shape(v), i, np.float32)
         for i, (p, v) in enumerate(tu.flatten_dict(params, sep="/").items())}
    )
    out = {}
    for name, tensor in jax_layoutlm_to_torch(marked).items():
        out[paths[int(tensor.flatten()[0])]] = name
    assert len(out) == len(paths)
    return out


def batches(rng, n_batches, lengths=(S, 100, 64, 1), n_labels=4):
    """OCR-chain batches: ids, 0-1000 boxes, labels with -100 on pad."""
    out = []
    for _ in range(n_batches):
        ids = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
        boxes = np.sort(rng.integers(0, 1000, (B, S, 2, 2)), axis=2).reshape(B, S, 4).astype(np.float32)
        mask = np.zeros((B, S), np.int32)
        for i, length in enumerate(lengths):
            mask[i, :length] = 1
        labels = rng.integers(0, n_labels, (B, S)).astype(np.int32)
        labels[mask == 0] = -100
        out.append({"vtext": ids, "tokenbox": boxes, "tokenlabels": labels, "visual_attention_mask": mask})
    return out


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JL.LayoutLMConfig(**TINY)
    model = JL.LayoutLMForTokenClassification(jcfg)
    ids = np.zeros((1, S), np.int32)
    params = model.init(jax.random.PRNGKey(0), ids, np.zeros((1, S, 4), np.int32))["params"]
    return jcfg, model, params


def port_model(jax_model):
    jcfg, _, params = jax_model
    model = LayoutLMForTokenClassification(port_cfg(jcfg))
    model.load_state_dict(jax_layoutlm_to_torch(params))
    return model


# ------------------------------------------------- flash backward, plain


class TestPlainBackward:
    @staticmethod
    def _case(rng, s, lengths):
        """Row i of the mask is real on its first lengths[i] positions, or,
        where lengths[i] is a tuple of (start, stop) spans, on those."""
        q, k, v, do = (rng.normal(size=(2, s, 2, 64)).astype(np.float32) for _ in range(4))
        if lengths is None:
            return q, k, v, do, None
        mask = np.zeros((2, s), np.float32)
        for i, row in enumerate(lengths):
            for start, stop in ((0, row),) if isinstance(row, int) else row:
                mask[i, start:stop] = 1.0
        return q, k, v, do, mask

    @pytest.mark.parametrize(
        "s,lengths",
        [(128, (128, 88)), (197, (197, 184)), (197, None), (100, (100, 1)),
         (256, (((0, 64), (128, 192)), ((64, 128), (192, 256)))),
         (256, (((0, 64), (192, 256)), ((0, 100), (170, 256))))],
        ids=["s128-pad40", "s197-pad13", "s197-mask-none", "s100-row-of-one",
             "s256-alternating-64-blocks", "s256-real-pad-real"],
    )
    def test_matches_pallas_vjp_at_every_position(self, rng, s, lengths):
        """dq, dk, dv against ``jax.vjp`` of ``_flash_self_attention`` run in
        Pallas interpret mode: a padded tail inside one 128 block, s padded
        to 256 inside, ``mask=None`` (an all-ones mask synthesised before
        the pad), a row of one real token (its pad queries see the pad
        keys and the zero keys of the 128 tail, which enter the backward
        only through the forward's statistics), and masks that are not a
        prefix, whose whole 64-row tiles share no id (the tile pairs the
        CUDA kernels skip): alternating blocks of 64 real and 64 pad, and a
        real block, pad, then a real block again."""
        import jax.experimental.pallas.tpu as pltpu

        q, k, v, do, mask = self._case(rng, s, lengths)
        jm = None if mask is None else jnp.asarray(mask)
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, b, c: JX._flash_self_attention(a, b, c, jm, 64),
                               jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            want = vjp(jnp.asarray(do))
        pm = None if mask is None else t(mask)
        o, stats = flash_self_attention_fwd_residuals(t(q), t(k), t(v), pm, 64)
        np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=0, atol=2e-5)
        got = flash_self_attention_backward(t(q), t(k), t(v), pm, o, stats, t(do), 64)
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert g.shape == q.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5, err_msg=name)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_residual_form_matches_autograd_of_the_plain_forward(self, rng, dtype):
        """The statistics are the row max and sum of the plain forward, and
        the backward equals autograd through it (float32: 1e-6; bf16: the
        backward rounds p and ds to bf16 where autograd does not, so 2^-6
        of each gradient's largest magnitude)."""
        q, k, v, do, mask = (t(a) for a in self._case(rng, 150, (150, 40)))
        q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
        o, (m, l) = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
        assert m.shape == l.shape == (2, 2, 150) and m.dtype == l.dtype == torch.float32
        ids = torch.nn.functional.pad(mask, (0, 106)).int()
        full = torch.einsum("nqhd,nkhd->nhqk", *(torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, 106))
                                                 for x in (q, k))) / 8.0
        full = full + torch.where(ids[:, None, :, None] == ids[:, None, None, :], 0.0, -0.7 * 3.4028234663852886e38)
        torch.testing.assert_close(m, full.amax(-1)[..., :150], rtol=0, atol=1e-6)
        torch.testing.assert_close(l, torch.exp(full - full.amax(-1, keepdim=True)).sum(-1)[..., :150],
                                   rtol=1e-6, atol=0)
        got = flash_self_attention_backward(q, k, v, mask, o, (m, l), do, 64)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        flash_self_attention(*leaves, mask, 64).backward(do.float())
        for g, leaf in zip(got, leaves):
            assert g.dtype == dtype
            err = (g.float() - leaf.grad).abs().max() / leaf.grad.abs().max()
            assert err <= (1e-6 if dtype == torch.float32 else 2 ** -6), float(err)


class TestSweepTool:
    def test_parses_block_shapes_and_needs_the_card(self, monkeypatch):
        """``tools.sweep_flash_backward`` reads K5:K4 pairs of three-digit
        block shapes, refuses a shape the kernels cannot take, and exits
        with a message where there is no CUDA device."""
        from vltk_tpu_torch.tools import sweep_flash_backward as sweep

        assert sweep.parse_shapes("223:133,222:124") == [(223, 133), (222, 124)]
        assert len(sweep.parse_shapes(sweep.DEFAULT_SHAPES)) == 4
        for bad in ("323:133", "203:133", "221:133", "22:133"):
            with pytest.raises(ValueError):
                sweep.parse_shapes(bad)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            sweep.main(["--shapes", "223:133"])

    def test_parses_forward_shapes_and_needs_the_card(self, monkeypatch):
        """``--forward`` reads K3's four-digit block shapes (warpgroups,
        blocks an SM, stages, key tile in 64-row units), refuses one the
        kernel cannot take, and exits with a message without a CUDA
        device."""
        from vltk_tpu_torch.tools import sweep_flash_backward as sweep

        assert sweep.parse_fwd_shapes("2231,1232") == [2231, 1232]
        assert 2231 in sweep.parse_fwd_shapes(sweep.DEFAULT_FWD_SHAPES)
        for bad in ("3231", "2201", "2213", "223", "2211"):
            with pytest.raises(ValueError):
                sweep.parse_fwd_shapes(bad)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            sweep.main(["--forward", "--shapes", "2231", "--variant", "flash_attention_copy.cu"])

    def test_ptxas_lines_name_each_kernel(self):
        """``_build.ptxas_lines`` keeps the register, spill and performance
        lines of ``-Xptxas -v`` and names each kernel: a nested (anonymous
        namespace, template) symbol, a plain mangled one whose parameter
        types are length-prefixed too, and an ``extern "C"`` one."""
        from vltk_tpu_torch.ops import _build

        out = "\n".join([
            "ptxas info    : 0 bytes gmem",
            "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__5860b625_22_flash_attention_bwd_cu_"
            "a50b7cef17flash_bwd_dq_bf16ILi1ELi3ELi3EEEvNS_4MapsENS_6ParamsE' for 'sm_90a'",
            "ptxas info    : Function properties for _ZN55_GLOBAL__N__5860b625_22_flash_attention_bwd_cu_"
            "a50b7cef17flash_bwd_dq_bf16ILi1ELi3ELi3EEEvNS_4MapsENS_6ParamsE",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas info    : Used 132 registers, used 1 barriers",
            "ptxas info    : Compiling entry function '_Z14flash_fwd_bf166Params' for 'sm_90a'",
            "ptxas info    : Used 128 registers, used 1 barriers, 46592 bytes smem",
            "ptxas info    : Compiling entry function 'nms_mask' for 'sm_90a'",
            "ptxas kernel.ptx, line 9; warning : Performance Loss: wgmma serialized",
            "ptxas info    : Used 32 registers",
        ])
        assert _build.ptxas_lines(out) == [
            "flash_bwd_dq_bf16: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "flash_bwd_dq_bf16: Used 132 registers, used 1 barriers",
            "flash_fwd_bf16: Used 128 registers, used 1 barriers, 46592 bytes smem",
            "ptxas kernel.ptx, line 9; warning : Performance Loss: wgmma serialized",
            "nms_mask: Used 32 registers",
        ]


# ---------------------------------------------------------------- losses


class TestLosses:
    @staticmethod
    def _grad_jax(fn, *args):
        return jax.value_and_grad(fn)(*args)

    @pytest.mark.parametrize("all_ignored", [False, True])
    def test_masked_cross_entropy_value_and_grad(self, rng, all_ignored):
        """Mean over the valid positions of the whole batch; 0 and a zero
        gradient (not NaN) when no position is valid."""
        logits = rng.normal(size=(3, 20, 5)).astype(np.float32)
        labels = rng.integers(0, 5, (3, 20)).astype(np.int32)
        labels[rng.random((3, 20)) < 0.3] = -100
        if all_ignored:
            labels[:] = -100
        want, want_g = self._grad_jax(lambda x: JX.masked_cross_entropy(x, labels), jnp.asarray(logits))
        x = t(logits).requires_grad_()
        got = masked_cross_entropy(x, t(labels))
        got.backward()
        got = got.detach()
        assert torch.isfinite(got) and bool(torch.isfinite(x.grad).all())
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)
        if all_ignored:
            assert float(got) == 0.0 and float(x.grad.abs().max()) == 0.0

    def test_token_classification_and_span_losses(self, rng):
        logits = rng.normal(size=(2, 30, 4)).astype(np.float32)
        labels = rng.integers(0, 4, (2, 30)).astype(np.int32)
        labels[:, 20:] = -7
        want = JL.token_classification_loss(jnp.asarray(logits), labels, -7)
        got = token_classification_loss(t(logits), t(labels), -7)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        start, end = (rng.normal(size=(3, 30)).astype(np.float32) for _ in range(2))
        ss = np.array([3, -100, 29], np.int32)
        se = np.array([5, -100, 29], np.int32)
        want = JL.span_qa_loss(jnp.asarray(start), jnp.asarray(end), ss, se)
        got = span_qa_loss(t(start), t(end), t(ss), t(se))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ host chain


class TestTokenLabels:
    @pytest.mark.parametrize("add_cls", [False, True])
    def test_matches_the_jax_processor(self, add_cls):
        """Word labels expanded by tokenmap, mapped through the label table
        (unknown labels -> ignore_id), cut and padded with ignore_id."""
        table = {"label": {"question": 0, "answer": 1, "other": 2}}
        for n_words, max_len in ((5, 16), (12, 10)):
            labels = [["question", "answer", "other", "header"][i % 4] for i in range(n_words)]
            tokenmap = np.array([(i % 3) + 1 for i in range(n_words)] + [-100] * 3, np.int32)
            outs = []
            for mod in (JV, PV):
                proc = mod.TokenLabels(max_visual_seq_length=max_len, add_visual_cls=add_cls,
                                       metadata_ids=table, ignore_id=-100)
                entry = {"label": list(labels), "tokenmap": tokenmap.copy()}
                outs.append(proc(entry)["tokenlabels"])
            assert outs[1].dtype == np.int32 and outs[1].shape == (max_len,)
            np.testing.assert_array_equal(outs[1], outs[0])
        entry = {"text": ["x"]}
        assert PV.TokenLabels()(dict(entry)) == entry  # no tokenmap: skipped


# -------------------------------------------------------------- optimizer


class TestOptimizer:
    def test_decay_group_equals_the_jax_mask(self, jax_model):
        """The decay rule on torch names equals ``_decay_mask`` on the flax
        paths, through the converter's name map: no decay for biases and
        LayerNorms (the embeddings' included), decay for embedding tables
        and kernels."""
        params = jax_model[2]
        mask = flat_jax(JO._decay_mask(params))
        names = name_map(params)
        assert {names[p]: bool(m) for p, m in mask.items()} == {n: PO.decays(n) for n in names.values()}
        assert PO.decays("layoutlm.embeddings.word_embeddings.weight")
        assert not PO.decays("layoutlm.embeddings.LayerNorm.weight")
        model = port_model(jax_model)
        groups = PO.param_groups(model, 0.01)
        assert sum(len(g["params"]) for g in groups) == len(list(model.parameters()))

    def test_schedule_matches_optax(self):
        """lr 0 at the first update, linear warmup, linear decay to 0
        (optax evaluates it in float32: 1e-5 relative)."""
        for total, ratio in ((10, 0.2), (7, 0.1), (100, 0.3)):
            sched = JO.linear_warmup_linear_decay(2e-3, total, ratio)
            factor = PO.linear_warmup_linear_decay(total, ratio)
            for count in range(total + 3):
                np.testing.assert_allclose(2e-3 * factor(count), float(sched(count)), rtol=1e-5, atol=1e-12)
            assert factor(0) == 0.0

    @pytest.mark.parametrize("clip", [1.0, 0.0, 1e6], ids=["clipped", "no-clip", "clip-inactive"])
    def test_five_steps_match_optax(self, jax_model, rng, clip):
        """Five AdamW updates from the same weights and synthetic gradients,
        with warmup, decay and the global-norm clip, against
        ``make_optimizer``'s optax chain: 1e-6."""
        _, _, params = jax_model
        cfg = JC.TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.2, clip_grad_norm=clip)
        tx = JO.make_optimizer(cfg, total_steps=10)
        state = tx.init(params)
        update = jax.jit(tx.update)
        names = name_map(params)
        model = port_model(jax_model)
        opt, sched = PO.make_optimizer(model, PC.TrainConfig(**{
            k: getattr(cfg, k) for k in ("learning_rate", "weight_decay", "warmup_ratio", "clip_grad_norm")
        }), total_steps=10)
        pdict = dict(model.named_parameters())
        jp = params
        for _ in range(5):
            grads = {p: rng.normal(size=v.shape).astype(np.float32) * 0.3 for p, v in flat_jax(jp).items()}
            updates, state = update(tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                                         for k, v in grads.items()}), state, jp)
            jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
            for p, g in grads.items():
                pdict[names[p]].grad = t(g.T if p.endswith("kernel") else g)
            opt.step()
            sched.step()
        for p, v in flat_jax(jp).items():
            got = pdict[names[p]].detach().numpy()
            np.testing.assert_allclose(got, v.T if p.endswith("kernel") else v, rtol=0, atol=1e-6, err_msg=p)

    def test_freeze_patterns_raise(self, jax_model):
        """A pattern that is no regex raises when the optimizer is made, as
        JAX's ``with_frozen`` raises when its labels are computed."""
        import re

        with pytest.raises(re.error):
            PO.make_optimizer(port_model(jax_model), PC.TrainConfig(), 10, freeze_patterns=("layer_(0",))
        with pytest.raises(re.error):
            JO.with_frozen(JO.make_optimizer(JC.TrainConfig(), 10), ("layer_(0",)).init(jax_model[2])

    @pytest.mark.parametrize("patterns, clip", [(("^layoutlm/embeddings/", "query"), 1.0), (("^classifier/",), 0.0)],
                             ids=["embeddings-and-queries-clipped", "classifier"])
    def test_freeze_patterns_match_optax(self, jax_model, rng, patterns, clip):
        """``freeze_patterns`` on torch names (dots as ``/``) freeze the
        tensors JAX's freeze on the flax paths, through the converter's name
        map; five steps with the clip taken over the trained tensors only
        equal optax's ``multi_transform`` (1e-6), and the frozen tensors stay
        bitwise as they were (no update, no weight decay)."""
        import re

        _, _, params = jax_model
        cfg = JC.TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.2, clip_grad_norm=clip)
        tx = JO.make_optimizer(cfg, total_steps=10, freeze_patterns=patterns)
        state = tx.init(params)
        update = jax.jit(tx.update)
        names = name_map(params)
        frozen_paths = {p for p in names if any(re.search(q, p) for q in patterns)}
        assert frozen_paths and {names[p] for p in frozen_paths} == {
            n for n in names.values() if PO.frozen(n, patterns)}
        model = port_model(jax_model)
        opt, sched = PO.make_optimizer(model, PC.TrainConfig(**{
            k: getattr(cfg, k) for k in ("learning_rate", "weight_decay", "warmup_ratio", "clip_grad_norm")
        }), total_steps=10, freeze_patterns=patterns)
        pdict = dict(model.named_parameters())
        before = {n: p.detach().clone() for n, p in pdict.items()}
        jp = params
        for _ in range(5):
            grads = {p: rng.normal(size=v.shape).astype(np.float32) * 0.3 for p, v in flat_jax(jp).items()}
            updates, state = update(tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                                         for k, v in grads.items()}), state, jp)
            jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
            for p, g in grads.items():
                pdict[names[p]].grad = t(g.T if p.endswith("kernel") else g)
            opt.step()
            sched.step()
        for p, v in flat_jax(jp).items():
            got = pdict[names[p]].detach()
            np.testing.assert_allclose(got.numpy(), v.T if p.endswith("kernel") else v, rtol=0, atol=1e-6, err_msg=p)
            assert torch.equal(got, before[names[p]]) == (p in frozen_paths), p


# ------------------------------------------------------------ train steps


def jax_train(jax_model, train_cfg, data, steps, accum_steps=1):
    jcfg, model, params = jax_model

    def loss_fn(p, batch, rng):
        logits = model.apply({"params": p}, batch["text"], batch["tokenbox"],
                             batch["visual_attention_mask"], deterministic=False, rngs={"dropout": rng})
        return JL.token_classification_loss(logits, batch["tokenlabels"]), {}

    tx = JO.make_optimizer(train_cfg, total_steps=10)
    state = JS.create_state(model.apply, params, tx)
    step = JS.make_train_step(loss_fn, donate=False, accum_steps=accum_steps)
    losses = []
    for i in range(steps):
        b = data[i]
        state, m = step(state, {"text": b["vtext"], "tokenbox": b["tokenbox"], "tokenlabels": b["tokenlabels"],
                                "visual_attention_mask": b["visual_attention_mask"]}, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return state.params, losses


def port_train(jax_model, train_cfg, data, steps, accum_steps=1):
    model = port_model(jax_model)

    def loss_fn(m, batch):
        logits = m(batch["vtext"], batch["tokenbox"], batch["visual_attention_mask"])
        return token_classification_loss(logits, batch["tokenlabels"]), {}

    opt, sched = PO.make_optimizer(model, train_cfg, total_steps=10)
    step = make_train_step(model, loss_fn, opt, sched, accum_steps=accum_steps)
    losses = [float(step({k: t(v) for k, v in data[i].items()})["loss"]) for i in range(steps)]
    return model, losses


class TestTrainStep:
    CFG = dict(learning_rate=3e-3, weight_decay=0.01, warmup_ratio=0.1, clip_grad_norm=1.0)

    def test_gradients_match_jax(self, jax_model):
        jcfg, model, params = jax_model
        b = batches(np.random.default_rng(3), 1)[0]

        def loss(p):
            logits = model.apply({"params": p}, b["vtext"], b["tokenbox"], b["visual_attention_mask"])
            return JL.token_classification_loss(logits, b["tokenlabels"])

        want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
        port = port_model(jax_model).train()
        got_loss = token_classification_loss(
            port(t(b["vtext"]), t(b["tokenbox"]), t(b["visual_attention_mask"])), t(b["tokenlabels"]))
        got_loss.backward()
        np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
        grads = dict(port.named_parameters())
        for p, name in name_map(params).items():
            w = flat_jax(want)[p]
            np.testing.assert_allclose(grads[name].grad.numpy(), w.T if p.endswith("kernel") else w,
                                       rtol=1e-4, atol=1e-4, err_msg=p)

    @pytest.mark.parametrize("steps", [1, 3])
    def test_steps_match_jax(self, jax_model, steps):
        """Loss and parameters after one and after three steps of
        ``make_train_step`` (AdamW, warmup, clip) against the JAX step."""
        data = batches(np.random.default_rng(4), steps)
        want_params, want_losses = jax_train(jax_model, JC.TrainConfig(**self.CFG), data, steps)
        model, losses = port_train(jax_model, PC.TrainConfig(**self.CFG), data, steps)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-4)
        pdict = dict(model.named_parameters())
        for p, name in name_map(jax_model[2]).items():
            w = flat_jax(want_params)[p]
            np.testing.assert_allclose(pdict[name].detach().numpy(), w.T if p.endswith("kernel") else w,
                                       rtol=1e-4, atol=1e-4, err_msg=p)

    def test_accumulation_equals_the_full_batch(self, jax_model):
        """accum_steps=2 over microbatches with equal valid-label counts is
        the full-batch step (and the JAX accumulated step)."""
        data = batches(np.random.default_rng(5), 2, lengths=(S, 77, S, 77))
        full, full_losses = port_train(jax_model, PC.TrainConfig(**self.CFG), data, 2)
        acc, acc_losses = port_train(jax_model, PC.TrainConfig(**self.CFG), data, 2, accum_steps=2)
        _, jax_losses = jax_train(jax_model, JC.TrainConfig(**self.CFG), data, 2, accum_steps=2)
        np.testing.assert_allclose(acc_losses, full_losses, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(acc_losses, jax_losses, rtol=1e-4, atol=1e-4)
        for (n, a), b in zip(acc.named_parameters(), full.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5, err_msg=n)

    def test_forced_flash_route_gives_the_dense_gradients(self, jax_model, monkeypatch):
        """The flash route forced on the CPU (the plain version, which
        autograd differentiates) against the dense route: parameter
        gradients within 1e-4, with padded rows (the loss ignores pad
        positions, and real positions never see pad keys on either
        route)."""
        b = {k: t(v) for k, v in batches(np.random.default_rng(6), 1)[0].items()}
        grads = {}
        for impl in ("xla", "flash"):
            calls = []
            if impl == "flash":
                monkeypatch.setattr(PX, "_flash_applicable", lambda s, det, drop, dev: s >= 128 and (det or drop == 0.0))

                def counted(*args):
                    calls.append(1)
                    return flash_self_attention(*args)

                monkeypatch.setattr(PX, "flash_attention_auto", counted)
            model = LayoutLMForTokenClassification(port_cfg(jax_model[0], attention_impl=impl))
            model.load_state_dict(port_model(jax_model).state_dict())
            model.train()
            token_classification_loss(model(b["vtext"], b["tokenbox"], b["visual_attention_mask"]),
                                      b["tokenlabels"]).backward()
            grads[impl] = {n: p.grad for n, p in model.named_parameters()}
            assert len(calls) == (2 if impl == "flash" else 0)
        for n, g in grads["flash"].items():
            np.testing.assert_allclose(g.numpy(), grads["xla"][n].numpy(), rtol=1e-4, atol=1e-4, err_msg=n)


# -------------------------------------------------------------- experiment


def port_experiment(jax_model, config, data, state_dict=None, cls=OCRTokenExperiment, **model_over):
    cfg = port_cfg(jax_model[0], **model_over)

    class Tiny(cls):
        model_config = cfg

        def build_model(self):
            model = super().build_model()
            if state_dict is not None:
                model.load_state_dict(state_dict)
            return model

    return Tiny(config, loaders=(data, None), device="cpu")


def port_config(tmp, **train):
    config = PC.Config()
    config.logdir = str(tmp)
    config.train.update(dict(dict(epochs=2, learning_rate=5e-3), **train))
    config.data.lang.update({"max_visual_seq_length": S})
    return config


def logged(exp):
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return [json.loads(line) for line in f]


class TestExperiment:
    def test_ocr_token_experiment_matches_jax(self, jax_model, tmp_path):
        """``OCRTokenExperiment`` end to end against the JAX one: the same
        list-of-numpy-batches loader and initial weights, 2 epochs of 3
        batches; logged losses step by step within 1e-4, token_acc equal."""
        from vltk_tpu.experiments.ocr_tokens import OCRTokenExperiment as JExp

        data = batches(np.random.default_rng(7), 3)
        jconfig = JC.Config()
        jconfig.logdir = str(tmp_path / "jax")
        jconfig.train.update({"epochs": 2, "learning_rate": 5e-3})
        jconfig.data.lang.update({"max_visual_seq_length": S})

        class JTiny(JExp):
            model_config = jax_model[0]

        jexp = JTiny(jconfig, loaders=(data, data[:1]))
        init = jax_layoutlm_to_torch(jax.device_get(jexp.state.params))
        want = jexp()
        pexp = port_experiment(jax_model, port_config(tmp_path / "port"), data, init)
        pexp.eval_loader = data[:1]
        got = pexp()
        jlog, plog = logged(jexp), logged(pexp)
        assert [r["step"] for r in plog] == [r["step"] for r in jlog] == list(range(1, 7))
        np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog], rtol=1e-4, atol=1e-4)
        assert [r["token_acc"] for r in plog] == [r["token_acc"] for r in jlog]
        assert got["eval"]["token_acc"] == want["eval"]["token_acc"]
        assert got["epoch"] == want["epoch"] == 1
        ckpt = os.path.join(pexp.ckpt_dir, "ocr_tokens_epoch_1.pt")
        assert os.path.exists(ckpt) and os.path.exists(os.path.join(pexp.ckpt_dir, "config.json"))
        with open(os.path.join(pexp.ckpt_dir, "info.json")) as f:
            info = json.load(f)
        assert info["step"] == 6 and "cpu" in info["rng"]
        assert open(os.path.join(pexp.logdir, "epoch_log.txt")).read().count("epoch=") == 2

    def test_registry_and_test_run(self, jax_model, tmp_path):
        assert Experiments.get("OCR_tokens") is OCRTokenExperiment
        assert Experiments.get("frcnn_detect").name == "frcnn_detect"  # ported (ROADMAP A.12)
        config = port_config(tmp_path)
        config.test_run = True
        exp = port_experiment(jax_model, config, batches(np.random.default_rng(8), 3))
        out = exp()
        assert out["epoch"] == 0 and len(logged(exp)) == 1


class _Raising(list):
    """A loader that fails when epoch ``fail_at`` starts, as a killed job."""

    fail_at = None

    def set_epoch(self, epoch):
        if epoch == self.fail_at:
            raise RuntimeError("killed")


class _Preempt(OCRTokenExperiment):
    """Receives the preemption flag after ``stop_after`` train steps."""

    stop_after = None

    def loss_fn(self, model, batch):
        out = super().loss_fn(model, batch)
        if self.global_step + 1 == self.stop_after:
            self._preempted = True
        return out


class TestResume:
    DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)

    def _params(self, exp):
        return {k: v.clone() for k, v in exp.model.state_dict().items()}

    def test_epoch_resume_is_bitwise_exact(self, jax_model, tmp_path):
        """Dropout on: 2 epochs straight against 1 epoch, a killed job, and
        a resume for the second; the RNG, AdamW and schedule states come
        back from the checkpoint."""
        data = batches(np.random.default_rng(9), 3)
        straight = port_experiment(jax_model, port_config(tmp_path / "a"), data, **self.DROPOUT)
        straight()
        loader = _Raising(data)
        loader.fail_at = 1
        first = port_experiment(jax_model, port_config(tmp_path / "b"), loader, **self.DROPOUT)
        with pytest.raises(RuntimeError, match="killed"):
            first()
        loader.fail_at = None
        resumed = port_experiment(jax_model, port_config(tmp_path / "b"), loader, **self.DROPOUT)
        assert resumed.start_epoch == 1 and resumed.global_step == 3
        resumed()
        a, b = self._params(straight), self._params(resumed)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert [r["loss"] for r in logged(resumed)] == [r["loss"] for r in logged(straight)]

    def test_mid_epoch_preemption_replays_exactly(self, jax_model, tmp_path):
        """A preemption after step 4 (mid epoch 1) writes one mid-epoch
        file; the resumed run re-enters epoch 1, skips its first batch and
        ends bitwise where the straight run ends; the epoch's save removes
        the mid file."""
        data = batches(np.random.default_rng(10), 3)
        straight = port_experiment(jax_model, port_config(tmp_path / "a"), data, **self.DROPOUT)
        straight()
        first = port_experiment(jax_model, port_config(tmp_path / "b"), data, cls=_Preempt, **self.DROPOUT)
        first.stop_after = 4
        out = first()
        assert out["preempted"] and out["epoch"] == 1
        mid = os.path.join(first.ckpt_dir, "ocr_tokens_epoch_1_mid.pt")
        assert os.path.exists(mid)
        resumed = port_experiment(jax_model, port_config(tmp_path / "b"), data, **self.DROPOUT)
        assert (resumed.start_epoch, resumed._skip_steps, resumed.global_step) == (1, 1, 4)
        resumed()
        a, b = self._params(straight), self._params(resumed)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not os.path.exists(mid)

    def test_periodic_async_saves_and_crash_save(self, jax_model, tmp_path):
        data = batches(np.random.default_rng(11), 3)
        config = port_config(tmp_path, save_every_steps=2, keep_checkpoints=1)
        config.save_on_crash = True
        exp = port_experiment(jax_model, config, data)
        exp()
        names = sorted(os.listdir(exp.ckpt_dir))
        assert "ocr_tokens_epoch_1.pt" in names and "ocr_tokens_epoch_0.pt" not in names
        assert not [n for n in names if n.endswith("_mid.pt")]
        loader = _Raising(data)
        loader.fail_at = 0
        crash = port_experiment(jax_model, port_config(tmp_path / "c", save_every_steps=0), loader)
        crash.config.save_on_crash = True
        with pytest.raises(RuntimeError):
            crash()
        assert os.path.exists(os.path.join(crash.ckpt_dir, "ocr_tokens_crash_epoch_0.pt"))
        assert os.path.exists(os.path.join(crash.ckpt_dir, "crash_info.json"))


# ------------------------------------------------------------------ guards


class TestGuards:
    def test_config_fields_match_jax(self):
        for port, ref in ((PC.TrainConfig, JC.TrainConfig), (PC.MeshConfig, JC.MeshConfig)):
            assert dataclasses.asdict(port()) == {k: v for k, v in dataclasses.asdict(ref()).items()}
        assert PC.LangConfig().ignore_id == JC.LangConfig().ignore_id
        assert PC.LangConfig().max_visual_seq_length == JC.LangConfig().max_visual_seq_length
        ref = JC.Config()
        for name in ("logdir", "test_run", "break_loop_on_test", "save_on_crash", "checkpoint_dir"):
            assert getattr(PC.Config(), name) == getattr(ref, name)
        cfg = PC.Config()
        cfg.update({"train": {"epochs": "3", "learning_rate": "2e-5"}})
        assert (cfg.train.epochs, cfg.train.learning_rate) == (3, 2e-5)
        assert cfg.train.overwritten == {"epochs": 4, "learning_rate": 1e-4}
        with pytest.raises(KeyError):
            cfg.update({"train": {"no_such": 1}})
        cfg.update({"mesh": {"zero1_axis": "data", "axes": "((data,2),(model,2))"}})  # ported (A.14a)
        assert cfg.mesh.zero1_axis == "data" and cfg.mesh.axes == (("data", 2), ("model", 2))
        # expert and pipe axes are ported (A.14b); what JAX rejects, the port
        # rejects with JAX's text, before any process group starts
        import jax

        from vltk_tpu.parallel import make_mesh as jax_make_mesh

        for axes in ((("data", 1), ("expert", 2)), (("pipe", 2), ("expert", -1))):
            with pytest.raises(ValueError) as want:
                jax_make_mesh(JC.MeshConfig(axes=axes), devices=jax.devices()[:1])
            with pytest.raises(ValueError) as got:
                PC.MeshConfig(axes=axes).build(device="cpu")
            assert str(got.value) == str(want.value)

    def test_experiment_guards(self, jax_model, tmp_path):
        config = port_config(tmp_path)
        with pytest.raises(ValueError, match="train loader"):  # loaders=None builds from config.data: none named
            OCRTokenExperiment(config, loaders=None, device="cpu")
        with pytest.raises(ValueError, match="need a mesh"):
            OCRTokenExperiment(config, loaders=([], None), rules=(), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                OCRTokenExperiment(config, loaders=(batches(np.random.default_rng(0), 1), None))
