"""CLI: ``python -m dcnn_tpu_torch.aot`` (counterpart of
``python -m dcnn_tpu.aot``).

- default: list the committed entries (key, label, size, age, hits, what
  they are for);
- ``--gc [--keep K]``: keep-K LRU sweep;
- ``--prewarm SRC``: fill a cache before deploying: build (or restore)
  and commit the kernel libraries, then build an
  :class:`~dcnn_tpu_torch.serve.engine.InferenceEngine` from ``SRC`` (a
  checkpoint directory or a model-zoo name, random weights from
  ``--seed``) whose exported serving program is committed. A server
  started against the same root then builds nothing
  (``InferenceEngine.from_model(..., aot_cache=ROOT)`` with the same
  weights and transform, or ``from_artifact``).

Exit codes: 0 success, 1 the operation failed, 2 usage or cache error.
``--json`` prints machine-readable reports.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .warm import aot_dir, enabled_root


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.aot",
        description="AOT cache of kernel libraries and exported programs: "
                    "list / gc / prewarm")
    p.add_argument("--dir", default=None,
                   help="cache ROOT (entries under <dir>/aot); default: "
                        "AOT_CACHE, then DCNN_COMPILE_CACHE, then the "
                        "kernel build directory")
    p.add_argument("--json", action="store_true",
                   help="print JSON instead of a table")
    p.add_argument("--gc", action="store_true",
                   help="remove all but the --keep most recently used "
                        "entries")
    p.add_argument("--keep", type=int, default=None,
                   help="retention for --gc (default: AOT_CACHE_KEEP or 64)")
    p.add_argument("--prewarm", metavar="SRC", default=None,
                   help="fill the cache: SRC is a checkpoint directory or "
                        "a model-zoo name")
    p.add_argument("--max-batch", type=int, default=32,
                   help="serve bucket cap for --prewarm (default 32)")
    p.add_argument("--no-fold", action="store_true",
                   help="skip BN folding in the prewarmed program")
    p.add_argument("--data-format", default="NCHW",
                   help="layout of a zoo model (default NCHW)")
    p.add_argument("--device", default=None,
                   help="device of the program (default: cuda)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of a zoo model's weights (default 0)")
    return p


def _resolve_root(arg_dir):
    explicit = enabled_root(arg_dir)
    if explicit is not None:
        return explicit
    from ..utils.compile_cache import resolve_cache_root
    return resolve_cache_root()


def _load_source(src: str, args):
    """A model from a checkpoint directory or a zoo name (weights from
    ``--seed``), on the CPU."""
    import torch

    if os.path.isdir(src):
        from ..train.checkpoint import load_checkpoint
        return load_checkpoint(src, device="cpu")[0]
    from ..models import MODEL_ZOO, create_model
    if src not in MODEL_ZOO:
        known = ", ".join(sorted(MODEL_ZOO))
        raise ValueError(f"{src!r} is neither a checkpoint dir nor a "
                         f"zoo model (known: {known})")
    model = create_model(src, args.data_format)
    return model.init(generator=torch.Generator().manual_seed(args.seed),
                      device="cpu")


def _prewarm(cache, args) -> dict:
    from ..ops import _kernels
    from ..serve.engine import InferenceEngine

    before = {e["key"] for e in cache.entries()}
    _kernels.build(cache=cache)
    committed = len({e["key"] for e in cache.entries()} - before)
    model = _load_source(args.prewarm, args)
    engine = InferenceEngine.from_model(
        model, fold=not args.no_fold, max_batch=args.max_batch,
        warmup=False, aot_cache=cache, device=args.device)
    return {"source": args.prewarm, "buckets": engine.bucket_sizes,
            "libraries": {"committed": committed},
            "program": engine.aot_info.get("program", {})}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        root = _resolve_root(args.dir)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from .cache import ExecutableCache
    try:
        cache = ExecutableCache(aot_dir(root), keep=args.keep)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.prewarm:
        try:
            report = _prewarm(cache, args)
        except Exception as e:
            print(f"prewarm failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps({"dir": cache.root, "prewarm": report},
                             indent=2))
        else:
            prog = report["program"]
            state = ("already cached" if prog.get("hit")
                     else "exported and committed")
            print(f"prewarmed {args.prewarm}: kernel libraries "
                  f"({report['libraries']['committed']} committed), serving "
                  f"program {state}, buckets {report['buckets']} "
                  f"-> {cache.root}")
        return 0

    if args.gc:
        removed = cache.gc(args.keep)
        if args.json:
            print(json.dumps({"dir": cache.root, "removed": removed,
                              "kept": len(cache.entries())}))
        else:
            print(f"gc: removed {removed}, kept {len(cache.entries())} "
                  f"({cache.root})")
        return 0

    rows = cache.entries()
    if args.json:
        print(json.dumps({"dir": cache.root, "entries": rows}, indent=2))
        return 0
    if not rows:
        print(f"{cache.root}: empty")
        return 0
    print(f"{cache.root}: {len(rows)} entries")
    print(f"{'key':16}  {'what':10} {'size':>10}  {'age':>8}  "
          f"{'hits':>5}  avals")
    for r in rows:
        if "error" in r:
            print(f"{r['key'][:16]:16}  {r['error']}")
            continue
        size = r.get("size") or 0
        mb = f"{size / 1e6:.1f}MB"
        age = r.get("age_s") or 0.0
        age_h = f"{age / 3600:.1f}h" if age >= 3600 else f"{age:.0f}s"
        print(f"{r['key'][:16]:16}  {r.get('what', ''):10} {mb:>10}  "
              f"{age_h:>8}  {r.get('hits', 0):>5}  {r.get('avals', '')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
