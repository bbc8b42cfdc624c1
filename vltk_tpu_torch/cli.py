"""CLI of the port: ``vltk-torch <command> ...`` (``python -m
vltk_tpu_torch.cli``), the counterpart of ``vltk_tpu/cli.py``:

  vltk-torch data <dataset:split> [...] [--flags]      build loaders, print a batch
  vltk-torch extract <extractor> <dataset> [--flags]   run feature extraction
  vltk-torch simple <experiment> [--flags]             run a registered experiment
  vltk-torch predict <image> <question...>             composed VQA inference
  vltk-torch serve [--bundle=vqa.zip]                  JSONL micro-batch server
  vltk-torch config [--flags]                          print the resolved config
  vltk-torch adapters | experiments                    list the registries
  vltk-torch --version

Flags: ``--yaml=file`` loads a base config; any ``--a.b.c=x`` dot flag
overrides it. ``predict`` takes ``--task=doc <doc.json>`` (per-word labels)
and ``--task=span <doc.json> <question...>`` (a document answer span),
``--frcnn= --lxmert= --answers=`` (VQA checkpoints), ``--ckpt=`` (LayoutLM),
``--bundle=`` (serve an exported bundle) and ``--export-bundle=``.
``predict``, ``serve``, ``extract`` and ``simple`` run on CUDA unless
``--device=cpu`` is given. ``simple`` with ``--mesh.axes`` set runs under
that mesh with ``parallel.LXMERT_RULES`` (``--mesh.zero1_axis=data`` adds
ZeRO-1), in one process or one process a rank::

  torchrun --nproc-per-node 4 -m vltk_tpu_torch.cli simple ocr_tokens \\
      --mesh.axes='((data,2),(model,2))'
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from typing import Dict, List, Tuple

from vltk_tpu_torch import __version__
from vltk_tpu_torch.config import Config, _coerce


def _parse_flags(argv: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """Split positionals from ``--key=value`` flags (``--flag`` -> true)."""
    positional, flags = [], {}
    for arg in argv:
        if arg.startswith("--"):
            body = arg[2:]
            key, value = body.split("=", 1) if "=" in body else (body, "true")
            flags[key.replace("-", "_")] = value
        else:
            positional.append(arg)
    return positional, flags


def _build_config(flags: Dict[str, str]) -> Config:
    flags = dict(flags)
    return Config.from_flags(flags.pop("yaml", None), **flags)


def _crash_report(cfg: Config, exc: BaseException) -> None:
    """Append the traceback to ``<logdir>/crash.txt``."""
    try:
        os.makedirs(cfg.logdir, exist_ok=True)
        path = os.path.join(cfg.logdir, "crash.txt")
        with open(path, "a") as f:
            f.write("".join(traceback.format_exception(exc)))
        print(f"crash report written to {path}", file=sys.stderr)
    except OSError:
        pass


def cmd_data(positional: List[str], cfg: Config) -> int:
    if positional:
        # "vqa:train" -> ("vqa", "train"); bare "vqa" -> all splits
        specs = [p.split(":", 1) if ":" in p else [p] for p in positional]
        cfg.data.update({"train_datasets": specs})
    from vltk_tpu_torch.experiments import Experiments

    Experiments.get("data")(cfg)()
    return 0


def cmd_extract(positional: List[str], cfg: Config, flags_extra: Dict) -> int:
    if len(positional) < 2:
        print("usage: vltk-torch extract <extractor> <dataset> [--flags]", file=sys.stderr)
        return 2
    from vltk_tpu_torch.adapters import Adapters

    extractor = Adapters.get(positional[0])
    # extras reach typed keyword arguments (FRCNNConfig overrides,
    # batch_size, device): "--int8=false" must arrive as False
    extractor.extract(cfg.data.datadir, dataset_name=positional[1], **{k: _coerce(v) for k, v in flags_extra.items()})
    return 0


def _random_init_note(what: str) -> None:
    print(f"[predict] no checkpoint given: RANDOM-INIT {what} - output exercises the pipeline, not a trained model",
          file=sys.stderr)


def _load_doc(path: str) -> Dict:
    with open(path) as f:
        doc = json.load(f)
    if "words" not in doc or "boxes" not in doc:
        raise ValueError(f"{path}: expected a json object with 'words' and 'boxes' (optional 'size': [h, w])")
    return doc


def _doc_predictor(cls, flags: Dict[str, str], make_random, from_ckpt):
    """A document predictor from ``--bundle``, ``--ckpt`` or random weights,
    with ``--export-bundle`` written when asked for."""
    device = flags.get("device")
    if "bundle" in flags:
        return cls.from_bundle(flags["bundle"], device=device)
    ckpt = flags.get("ckpt")
    pred = from_ckpt(ckpt, device) if ckpt is not None else make_random(device)
    if "export_bundle" in flags:
        out = pred.export_bundle(flags["export_bundle"])
        print(f"[predict] wrote serving bundle: {out}", file=sys.stderr)
    return pred


def _predict_doc(positional: List[str], flags: Dict[str, str]) -> int:
    """``predict --task=doc <doc.json>``: per-word labels (DocTokenClassifier)."""
    if len(positional) != 1:
        print("usage: vltk-torch predict --task=doc <doc.json> [--labels=labels.json --ckpt=layoutlm.pt]",
              file=sys.stderr)
        return 2
    from vltk_tpu_torch.predict import DocTokenClassifier

    labels = flags.get("labels") or ["other", "question", "answer", "header"]  # FUNSD's

    def make_random(device):
        _random_init_note("LayoutLM weights")
        return DocTokenClassifier(labels, batch_size=1, device=device)

    clf = _doc_predictor(
        DocTokenClassifier, flags, make_random,
        lambda ckpt, device: DocTokenClassifier.from_pretrained(ckpt, labels, batch_size=1, device=device),
    )
    (res,) = clf([_load_doc(positional[0])])
    print(json.dumps([{"word": r["word"], "label": r["label"], "score": round(r["score"], 4)} for r in res]))
    return 0


def _predict_span(positional: List[str], flags: Dict[str, str]) -> int:
    """``predict --task=span <doc.json> <question...>``: a document answer
    span (DocSpanQA)."""
    if len(positional) < 2:
        print("usage: vltk-torch predict --task=span <doc.json> <question...> [--ckpt=layoutlm_qa.pt]",
              file=sys.stderr)
        return 2
    from vltk_tpu_torch.predict import DocSpanQA

    def make_random(device):
        _random_init_note("LayoutLM span-QA weights")
        return DocSpanQA(batch_size=1, device=device)

    qa = _doc_predictor(
        DocSpanQA, flags, make_random,
        lambda ckpt, device: DocSpanQA.from_pretrained(ckpt, batch_size=1, device=device),
    )
    (res,) = qa([_load_doc(positional[0])], [" ".join(positional[1:])])
    print(json.dumps({"answer": res["answer"], "start_word": res["start_word"], "end_word": res["end_word"],
                      "score": round(res["score"], 4)}))
    return 0


def cmd_predict(positional: List[str], flags: Dict[str, str]) -> int:
    """``predict <image> <question words...>``: composed VQA. With
    ``--frcnn= --lxmert=`` checkpoints and ``--answers=`` it answers for
    real; without them it runs the whole path at random weights (said
    loudly). ``--bundle=vqa.zip`` serves an exported bundle;
    ``--export-bundle=vqa.zip`` writes one after building the predictor."""
    task = flags.get("task", "vqa")
    if "bundle" in flags and "export_bundle" in flags:
        # a bundle holds a traced program: there is nothing to trace again
        print("--export-bundle cannot be combined with --bundle (export from checkpoints or random init)",
              file=sys.stderr)
        return 2
    if task == "doc":
        return _predict_doc(positional, flags)
    if task == "span":
        return _predict_span(positional, flags)
    if task != "vqa":
        print(f"unknown --task={task!r} (vqa|doc|span)", file=sys.stderr)
        return 2
    if len(positional) < 2:
        print("usage: vltk-torch predict <image> <question...> "
              "[--answers=labels.json --frcnn=ckpt.pt --lxmert=ckpt.pt --top_k=5]", file=sys.stderr)
        return 2
    image, question = positional[0], " ".join(positional[1:])
    from vltk_tpu_torch.predict import VQAPredictor

    frcnn, lxmert = flags.get("frcnn"), flags.get("lxmert")
    answers = flags.get("answers")
    device = flags.get("device")
    top_k = int(flags.get("top_k", "5"))
    if "bundle" in flags:
        predictor = VQAPredictor.from_bundle(flags["bundle"], device=device)
    elif (frcnn is None) != (lxmert is None):
        print("--frcnn and --lxmert must be given together", file=sys.stderr)
        return 2
    elif frcnn is not None:
        if answers is None:
            print("--answers is required with checkpoints", file=sys.stderr)
            return 2
        predictor = VQAPredictor.from_pretrained(frcnn, lxmert, answers, batch_size=1, device=device)
    else:
        _random_init_note("weights")
        predictor = VQAPredictor(answers or ["yes", "no", "unknown"], batch_size=1, device=device)
    if "export_bundle" in flags:
        out = predictor.export_bundle(flags["export_bundle"])
        print(f"[predict] wrote serving bundle: {out}", file=sys.stderr)
    (res,) = predictor([image], [question], top_k=top_k)
    print(json.dumps({
        "question": question,
        "answer": res["answer"],
        "score": round(res["score"], 4),
        "topk": [(a, round(s, 4)) for a, s in res["topk"]],
        "num_boxes": res["num_boxes"],
    }))
    return 0


_KIND_TO_TASK = {"vqa_predictor": "vqa", "doc_token_classifier": "doc", "doc_span_qa": "span"}


def cmd_serve(positional: List[str], flags: Dict[str, str], stdin=None, stdout=None) -> int:
    """``serve``: a JSONL server on stdin/stdout. One JSON request a line in,
    one JSON result a line out, in input order; concurrent requests share
    the predictor's fixed-shape buckets (``serving.MicroBatchServer``).

    Sources: ``--bundle=file.zip`` (the task from the bundle's manifest:
    vqa, doc or span), ``--frcnn= --lxmert= --answers=`` (VQA checkpoints),
    or nothing (random-weight VQA).

    Requests: vqa ``{"image": "path.jpg", "question": "..."}``; doc
    ``{"words": [...], "boxes": [[x0,y0,x1,y1]...], "size": [h,w]}``; span
    ``{"doc": {words, boxes, size}, "question": "..."}``.
    """
    import queue as queue_mod
    import threading
    from concurrent.futures import Future

    from vltk_tpu_torch.predict import DocSpanQA, DocTokenClassifier, VQAPredictor
    from vltk_tpu_torch.serving import for_doc, for_span, for_vqa

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    max_delay = float(flags.get("max_delay_ms", "5"))
    workers = int(flags.get("workers", "1"))
    device = flags.get("device")
    if "bundle" in flags:
        from vltk_tpu_torch.aot import bundle_manifest

        kind = bundle_manifest(flags["bundle"])["meta"].get("kind")
        task = _KIND_TO_TASK.get(kind)
        if task is None:
            print(f"unknown bundle kind {kind!r}", file=sys.stderr)
            return 2
        cls = {"vqa": VQAPredictor, "doc": DocTokenClassifier, "span": DocSpanQA}[task]
        predictor = cls.from_bundle(flags["bundle"], device=device)
    else:
        task = flags.get("task", "vqa")
        if task != "vqa":
            print("--task=doc|span serving needs --bundle (export one with "
                  "`vltk-torch predict --task=... --export-bundle=`)", file=sys.stderr)
            return 2
        frcnn, lxmert, answers = flags.get("frcnn"), flags.get("lxmert"), flags.get("answers")
        if frcnn is not None and lxmert is not None and answers is not None:
            predictor = VQAPredictor.from_pretrained(frcnn, lxmert, answers, device=device)
        else:
            _random_init_note("weights")
            predictor = VQAPredictor(answers or ["yes", "no", "unknown"], device=device)

    if task == "vqa":
        srv = for_vqa(predictor, max_delay_ms=max_delay, top_k=int(flags.get("top_k", "5")), workers=workers)
        to_request = lambda r: (r["image"], r["question"])  # noqa: E731
        to_line = lambda res: {  # noqa: E731
            "answer": res["answer"],
            "score": round(float(res["score"]), 4),
            "topk": [(a, round(float(s), 4)) for a, s in res["topk"]],
            "num_boxes": int(res["num_boxes"]),
        }
    elif task == "doc":
        srv = for_doc(predictor, max_delay_ms=max_delay, workers=workers)

        def to_request(r):
            # a malformed document fails its own request, before batching
            missing = [k for k in ("words", "boxes") if k not in r]
            if missing:
                raise ValueError(f"doc request missing keys {missing}")
            return r

        to_line = lambda res: [  # noqa: E731
            {"word": w["word"], "label": w["label"], "score": round(float(w["score"]), 4)} for w in res
        ]
    else:
        srv = for_span(predictor, max_delay_ms=max_delay, workers=workers)
        to_request = lambda r: (r["doc"], r["question"])  # noqa: E731
        to_line = lambda res: {  # noqa: E731
            "answer": res["answer"],
            "start_word": int(res["start_word"]),
            "end_word": int(res["end_word"]),
            "score": round(float(res["score"]), 4),
        }

    if flags.get("warmup") == "true" and hasattr(predictor, "warmup"):
        predictor.warmup()
    print(f"[serve] ready: task={task} bucket={predictor.batch_size} window={max_delay}ms", file=sys.stderr)
    # a writer thread prints each result the moment it is done, in
    # submission order, while this thread keeps reading: a client that
    # waits for each reply before its next line must not deadlock
    outq: "queue_mod.Queue" = queue_mod.Queue()

    def _writer():
        while True:
            fut = outq.get()
            if fut is None:
                return
            try:
                line = json.dumps(to_line(fut.result()))
            except Exception as exc:  # noqa: BLE001 - one request failed; keep serving
                line = json.dumps({"error": str(exc)})
            print(line, file=stdout, flush=True)

    writer = threading.Thread(target=_writer, daemon=True)
    writer.start()
    with srv:
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = to_request(json.loads(line))
            except Exception as exc:  # noqa: BLE001 - a bad line keeps its place in the output
                fut: "Future" = Future()
                fut.set_exception(ValueError(f"bad request: {exc}"))
                outq.put(fut)
            else:
                outq.put(srv.submit(req))
        outq.put(None)
        writer.join()
    print(f"[serve] done: {srv.stats}", file=sys.stderr)
    return 0


def cmd_simple(positional: List[str], cfg: Config, extra: Dict[str, str] = None) -> int:
    """``simple <experiment>``: run a registered experiment. When the user
    set ``mesh.axes`` (the JAX CLI's rule: the untouched default stays
    mesh-less) the mesh is built over the process group (torchrun's, or a
    one-rank group) with ``LXMERT_RULES``, as the JAX CLI does; ``pipe``
    and ``expert`` ranks are then replicas (no rule cuts an expert stack
    and no experiment runs a pipeline, as in JAX)."""
    if not positional:
        print("usage: vltk-torch simple <experiment> [--flags]", file=sys.stderr)
        return 2
    from vltk_tpu_torch.experiments import Experiments

    exp_cls = Experiments.get(positional[0])
    device = (extra or {}).get("device")
    kwargs = {} if device is None else {"device": device}
    if "axes" in cfg.mesh.overwritten:
        axes = tuple(cfg.mesh.axes)
        if not all(isinstance(a, (tuple, list)) and len(a) == 2 for a in axes):
            raise ValueError(
                f"mesh.axes must be ((name, size), ...) pairs, got {axes!r} "
                "- e.g. --mesh.axes='((data,4),(model,2))'")
        from vltk_tpu_torch.parallel import LXMERT_RULES

        kwargs.update(mesh=cfg.mesh.build(device=device), rules=LXMERT_RULES)
    print(exp_cls(cfg, **kwargs)())
    return 0


def main(argv: List[str] = None) -> int:
    try:  # die quietly when piped into `head`
        import signal

        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (ImportError, ValueError, AttributeError):
        pass
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] == "--version":
        print(f"vltk-tpu-torch {__version__}")
        return 0
    command, rest = argv[0], argv[1:]
    positional, flags = _parse_flags(rest)

    if command == "adapters":
        from vltk_tpu_torch.adapters import Adapters

        print("\n".join(Adapters.avail()))
        return 0
    if command == "experiments":
        from vltk_tpu_torch.experiments import Experiments

        print("\n".join(Experiments.avail()))
        return 0
    if command == "predict":
        return cmd_predict(positional, flags)
    if command == "serve":
        return cmd_serve(positional, flags)

    # config-consuming commands: known config dot flags vs extras
    known_top = {f for f in Config.__dataclass_fields__}
    cfg_flags = {k: v for k, v in flags.items() if k.split(".")[0] in known_top or k == "yaml"}
    extra = {k: v for k, v in flags.items() if k not in cfg_flags}
    cfg = _build_config(cfg_flags)

    try:
        if command == "config":
            cfg.print_config()
            return 0
        if command == "data":
            return cmd_data(positional, cfg)
        if command == "extract":
            return cmd_extract(positional, cfg, extra)
        if command == "simple":
            return cmd_simple(positional, cfg, extra)
    except KeyError as exc:
        # a registry miss ("unknown adapter/experiment ...; available:
        # [...]") is a typo, not a crash: its message, no traceback
        msg = exc.args[0] if exc.args else str(exc)
        if isinstance(msg, str) and msg.startswith("unknown "):
            print(msg, file=sys.stderr)
            return 2
        _crash_report(cfg, exc)
        raise
    except Exception as exc:  # noqa: BLE001 - the CLI's boundary
        _crash_report(cfg, exc)
        raise
    print(f"unknown command {command!r}", file=sys.stderr)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
