"""The port's micro-batch server (``vltk_tpu_torch/serving.py``): coalescing,
order, per-request errors, drain on close, the slow-batch warning and
several workers, as the JAX package's ``tests/test_serving.py`` holds its
own; then ``for_doc``, ``for_vqa`` and ``for_span`` over tiny CPU
predictors, whose answers through the server equal one direct batched
call. Every ``Future.result``, ``join``, ``Barrier.wait`` and ``close``
here has a timeout, so no test can hang the suite.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from vltk_tpu_torch.serving import MicroBatchServer, for_doc, for_span, for_vqa

WAIT = 60  # seconds: every wait in this file ends by then


class _Recorder:
    """batch_fn that records call sizes and maps each request r -> f(r)."""

    def __init__(self, fn=lambda r: r * 10, delay=0.0):
        self.sizes = []
        self.fn = fn
        self.delay = delay
        self.lock = threading.Lock()

    def __call__(self, requests):
        if self.delay:
            time.sleep(self.delay)
        with self.lock:
            self.sizes.append(len(requests))
        return [self.fn(r) for r in requests]


def run_callers(srv, requests):
    """One thread a request, released together; each result by request
    index."""
    results = {}
    barrier = threading.Barrier(len(requests))

    def caller(i):
        barrier.wait(timeout=WAIT)
        results[i] = srv.submit(requests[i]).result(timeout=WAIT)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive()
    return results


def test_single_request_roundtrip():
    rec = _Recorder()
    srv = MicroBatchServer(rec, batch_size=4, max_delay_ms=1)
    assert srv.submit(7).result(timeout=WAIT) == 70
    srv.close(timeout=WAIT)
    assert rec.sizes == [1]


def test_burst_coalesces_into_buckets():
    """32 concurrent callers over batch_size 8 land in far fewer calls."""
    rec = _Recorder(delay=0.01)
    srv = MicroBatchServer(rec, batch_size=8, max_delay_ms=50)
    results = run_callers(srv, list(range(32)))
    srv.close(timeout=WAIT)
    assert results == {i: i * 10 for i in range(32)}
    assert sum(rec.sizes) == 32
    assert len(rec.sizes) <= 8
    assert max(rec.sizes) == 8
    stats = srv.stats
    assert stats["requests_served"] == 32
    lat = stats["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]


def test_results_keep_request_order_within_bucket():
    rec = _Recorder()
    srv = MicroBatchServer(rec, batch_size=16, max_delay_ms=100)
    futs = [srv.submit(i) for i in range(10)]
    assert [f.result(timeout=WAIT) for f in futs] == [i * 10 for i in range(10)]
    srv.close(timeout=WAIT)


def test_error_fans_out_to_all_callers():
    def boom(requests):
        raise ValueError("device fell over")

    srv = MicroBatchServer(boom, batch_size=4, max_delay_ms=20)
    futs = [srv.submit(i) for i in range(3)]
    for f in futs:
        with pytest.raises(ValueError, match="fell over"):
            f.result(timeout=WAIT)
    srv.close(timeout=WAIT)


def test_poisoned_request_fails_alone():
    def fragile(requests):
        if any(r == "bad" for r in requests):
            raise ValueError("poisoned")
        return [r * 10 for r in requests]

    srv = MicroBatchServer(fragile, batch_size=4, max_delay_ms=200)
    futs = [srv.submit(r) for r in (1, "bad", 2)]
    assert futs[0].result(timeout=WAIT) == 10
    with pytest.raises(ValueError, match="poisoned"):
        futs[1].result(timeout=WAIT)
    assert futs[2].result(timeout=WAIT) == 20
    srv.close(timeout=WAIT)
    assert srv.stats["requests_served"] == 2


def test_wrong_result_count_is_an_error():
    srv = MicroBatchServer(lambda reqs: [0], batch_size=4, max_delay_ms=20)
    futs = [srv.submit(i) for i in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="results"):
            f.result(timeout=WAIT)
    srv.close(timeout=WAIT)


def test_cancelled_future_does_not_kill_worker():
    """A future cancelled while queued is dropped; the worker lives on."""
    rec = _Recorder(delay=0.05)
    srv = MicroBatchServer(rec, batch_size=1, max_delay_ms=0)
    warm = srv.submit(0)
    doomed = srv.submit(1)
    assert doomed.cancel()
    assert warm.result(timeout=WAIT) == 0
    assert srv.submit(2).result(timeout=WAIT) == 20
    srv.close(timeout=WAIT)
    assert doomed.cancelled()
    assert srv.stats["requests_served"] == 2
    assert sum(rec.sizes) == 2


def test_close_drains_pending_and_refuses_new():
    rec = _Recorder()
    srv = MicroBatchServer(rec, batch_size=4, max_delay_ms=500)
    futs = [srv.submit(i) for i in range(6)]
    srv.close(timeout=WAIT)  # serves all 6, not abandoning the window
    assert [f.result(timeout=WAIT) for f in futs] == [i * 10 for i in range(6)]
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(0)


def test_close_times_out_on_a_stuck_batch():
    release = threading.Event()

    def stuck(requests):
        release.wait(timeout=WAIT)
        return requests

    srv = MicroBatchServer(stuck, batch_size=1, max_delay_ms=0)
    fut = srv.submit(1)
    with pytest.raises(TimeoutError, match="still running"):
        srv.close(timeout=0.05)
    release.set()
    srv.close(timeout=WAIT)
    assert fut.result(timeout=WAIT) == 1


def test_slow_batch_warns_and_is_tracked():
    rec = _Recorder(delay=0.05)
    with pytest.warns(UserWarning, match="MicroBatchServer: one batch"):
        srv = MicroBatchServer(rec, batch_size=2, max_delay_ms=1, slow_batch_warn_s=0.01)
        assert srv.submit(3).result(timeout=WAIT) == 30
        srv.close(timeout=WAIT)
    assert srv.stats["slowest_batch_ms"] >= 50.0
    rec2 = _Recorder()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        srv = MicroBatchServer(rec2, batch_size=2, max_delay_ms=1)
        assert srv.submit(1).result(timeout=WAIT) == 10
        srv.close(timeout=WAIT)
    assert not [w for w in caught if "MicroBatchServer" in str(w.message)]


@pytest.mark.parametrize("kwargs,match", [(dict(batch_size=0), "batch_size"),
                                          (dict(batch_size=1, workers=0), "workers")])
def test_bad_arguments_rejected(kwargs, match):
    with pytest.raises(ValueError, match=match):
        MicroBatchServer(lambda r: r, **kwargs)


def test_multi_worker_overlap_correctness():
    rec = _Recorder(delay=0.02)
    srv = MicroBatchServer(rec, batch_size=4, max_delay_ms=10, workers=2)
    results = run_callers(srv, list(range(24)))
    srv.close(timeout=WAIT)
    assert results == {i: i * 10 for i in range(24)}
    assert srv.stats["requests_served"] == 24
    assert sum(rec.sizes) == 24


def test_multi_worker_close_drains_everything():
    rec = _Recorder()
    srv = MicroBatchServer(rec, batch_size=4, max_delay_ms=500, workers=3)
    futs = [srv.submit(i) for i in range(10)]
    srv.close(timeout=WAIT)
    assert [f.result(timeout=WAIT) for f in futs] == [i * 10 for i in range(10)]
    assert not any(th.is_alive() for th in srv._workers)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(0)


def test_stress_many_workers_lose_no_request():
    """More workers than cores, a short switch interval: every request is
    served exactly once and the counts add up."""
    import sys

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rec = _Recorder()
        srv = MicroBatchServer(rec, batch_size=3, max_delay_ms=1, workers=16)
        results = run_callers(srv, list(range(200)))
        srv.close(timeout=WAIT)
    finally:
        sys.setswitchinterval(saved)
    assert results == {i: i * 10 for i in range(200)}
    assert sum(rec.sizes) == 200 == srv.stats["requests_served"]


# ------------------------------------------------------ the predictors


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is", "the", "color", "cat", "on", "box", "##s"]
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


WORDS = ["what", "is", "the", "color", "cat", "cats", "on", "boxs", "box"]


def documents(n, seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        k = int(rng.integers(3, 30))
        xy = rng.integers(0, 800, (k, 2))
        docs.append({"words": list(rng.choice(WORDS, k)),
                     "boxes": np.concatenate([xy, xy + rng.integers(1, 150, (k, 2))], 1).tolist()})
    return docs


def layoutlm_config():
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    return LayoutLMConfig(vocab_size=64, hidden_size=32, num_heads=2, intermediate_size=48, l_layers=2,
                          max_position_embeddings=64)


def test_for_doc_equals_one_batched_call(tiny_vocab):
    """2 x batch + 3 concurrent single documents through ``for_doc``: each
    caller's labels and scores equal the same document in one direct call
    over all of them (every bucket pads to the same static batch)."""
    from vltk_tpu_torch.data.tokenizer import Tokenizer
    from vltk_tpu_torch.predict import DocTokenClassifier

    clf = DocTokenClassifier(["a", "b", "c", "d"], config=layoutlm_config(), batch_size=2, max_seq_length=48,
                             device="cpu", tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=48))
    docs = documents(2 * clf.batch_size + 3)
    want = clf(docs)
    srv = for_doc(clf, max_delay_ms=20)
    got = run_callers(srv, docs)
    srv.close(timeout=WAIT)
    assert [got[i] for i in range(len(docs))] == want
    assert srv.stats["requests_served"] == len(docs)


def test_for_span_equals_one_batched_call(tiny_vocab):
    from vltk_tpu_torch.data.tokenizer import Tokenizer
    from vltk_tpu_torch.predict import DocSpanQA

    qa = DocSpanQA(config=layoutlm_config(), batch_size=2, question_len=8, doc_len=24, device="cpu",
                   tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=8))
    docs = documents(5, seed=1)
    questions = ["what is the cat", "color", "what is on the box", "the cat", "is"]
    want = qa(docs, questions)
    srv = for_span(qa, max_delay_ms=20)
    got = run_callers(srv, list(zip(docs, questions)))
    srv.close(timeout=WAIT)
    assert [got[i] for i in range(len(docs))] == want


def test_for_vqa_equals_one_batched_call(tiny_vocab):
    from vltk_tpu_torch.data.tokenizer import Tokenizer
    from vltk_tpu_torch.models.frcnn import FRCNNConfig
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.predict import VQAPredictor

    frcnn = FRCNNConfig(depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4,
                        rpn_hidden_channels=16, anchor_sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0),
                        pre_nms_topk=64, post_nms_topk=16, num_classes=7, num_attrs=5, pooler_resolution=7,
                        min_detections=4, max_detections=4)
    lxmert = LxmertConfig(vocab_size=64, hidden_size=24, num_heads=2, intermediate_size=48, l_layers=2,
                          x_layers=1, r_layers=1, visual_feat_dim=128, max_position_embeddings=32,
                          num_answers=5, num_objects=7, num_attrs=5)
    pred = VQAPredictor(["yes", "no", "red", "2", "cat"], frcnn_config=frcnn, lxmert_config=lxmert, batch_size=2,
                        tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=8), raw_canvas=(64, 64),
                        resized_canvas=(64, 64), short=32.0, maximum=64.0, device="cpu")
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, (48, 56, 3)).astype(np.uint8) for _ in range(4)]
    questions = [f"what is the cat {i}" for i in range(4)]
    with torch.inference_mode():
        want = pred(images, questions, top_k=2)
    srv = for_vqa(pred, max_delay_ms=200, top_k=2)
    got = run_callers(srv, list(zip(images, questions)))
    srv.close(timeout=WAIT)
    assert srv.stats["batches_run"] <= 3  # coalesced (buckets of 2), not 4 calls of one
    for i, w in enumerate(want):
        assert got[i]["answer"] == w["answer"]
        assert [a for a, _ in got[i]["topk"]] == [a for a, _ in w["topk"]]
        np.testing.assert_array_equal(got[i]["objects"], w["objects"])
        np.testing.assert_allclose(got[i]["score"], w["score"], rtol=1e-6)
