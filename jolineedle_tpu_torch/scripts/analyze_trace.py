"""Split a ``torch.profiler`` Chrome trace's device time by class and by
kernel name (the counterpart of ``scripts/analyze_trace.py``, which reads a
``jax.profiler`` trace).

    python -m jolineedle_tpu_torch.scripts.analyze_trace TRACE [--top N]

``TRACE`` is a Chrome trace JSON file (``BENCH_PROFILE_DIR``'s
``bench_trace.json``) or a directory searched for ``*.json``. The device's
events (Chrome-trace categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``) are summed by class: the port's own kernels
(``csrc/*.cu``), convolution (cuDNN), gemm, elementwise, reduce, copy or
memset, and other; and by name within each class. A device event nests
nothing, so its exclusive time is its duration. Also printed: the device's
busy time (the union of its events' intervals) against the trace's window
(first to last event of any kind), the busy share.

Host-only: the module imports neither ``torch`` nor ``jax`` and runs while
the card works.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Name patterns per class, checked in this order: a port kernel's name
#: holds "conv", a cuDNN conv's may hold "gemm", a cast is an elementwise
#: kernel of a copy functor, a random draw's name may hold "normal".
CLASSES = [
    ("port kernels", ("flash_fwd_kernel", "dwblock_kernel", "conv3x3_tile_kernel")),
    ("copy/memset", ("memcpy", "memset", "copy")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "cublas", "matmul")),
    ("elementwise", ("elementwise", "distribution", "index", "fill", "gather", "scatter",
                     "where")),
    ("reduce", ("reduce", "softmax", "norm", "scan", "argmax", "sum", "max")),
]


def classify(name: str, category: str) -> str:
    if category in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    n = name.lower()
    for cls, patterns in CLASSES:
        if any(p in n for p in patterns):
            return cls
    return "other"


def load_events(trace: Path) -> list:
    paths = sorted(trace.rglob("*.json")) if trace.is_dir() else [trace]
    if not paths:
        raise SystemExit(f"no *.json trace under {trace}")
    events = []
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        events += data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def analyze(events: list) -> dict:
    """Times in ms: ``total`` (summed device events), ``busy`` (their union),
    ``window`` (every event's span), ``by_class`` and ``by_name`` ({class:
    {name: [ms, count]}})."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    by_class = collections.Counter()
    by_name = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for e in device:
        cls = classify(e["name"], e["cat"])
        ms = float(e["dur"]) / 1e3
        by_class[cls] += ms
        by_name[cls][e["name"]][0] += ms
        by_name[cls][e["name"]][1] += 1
    starts = [float(e["ts"]) for e in events]
    ends = [float(e["ts"]) + float(e["dur"]) for e in events]
    window = (max(ends) - min(starts)) / 1e3 if events else 0.0
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device) / 1e3
    return {"total_ms": sum(by_class.values()), "busy_ms": busy, "window_ms": window,
            "busy_pct": 100 * busy / window if window else 0.0,
            "by_class": dict(by_class),
            "by_name": {c: {n: list(v) for n, v in names.items()} for c, names in by_name.items()}}


def main(argv=None, device=None) -> dict:
    """Print the split of the trace named in ``argv``; return it. ``device``
    is not used (the analysis reads a file on the host); it is taken for the
    scripts' common call form."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a Chrome trace JSON file, or a directory of them")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    out = analyze(load_events(Path(args.trace)))
    if not out["by_class"]:
        raise SystemExit(f"no device events in {args.trace}: was the card traced?")
    total = out["total_ms"]
    print(f"total device op time: {total:.3f} ms (exclusive, summed over device events)")
    print(f"device busy: {out['busy_ms']:.3f} ms of a {out['window_ms']:.3f} ms window"
          f" ({out['busy_pct']:.1f} %)\n")
    print(f"{'class':28s} {'ms':>10s} {'%':>6s}")
    for cls, ms in sorted(out["by_class"].items(), key=lambda kv: -kv[1]):
        print(f"{cls:28s} {ms:10.3f} {100 * ms / total:6.1f}")
    for cls in sorted(out["by_class"], key=lambda c: -out["by_class"][c]):
        names = sorted(out["by_name"][cls].items(), key=lambda kv: -kv[1][0])
        print(f"\n{cls}: top {min(args.top, len(names))} of {len(names)} kernels")
        print(f"{'n':>6s} {'ms':>10s} {'%':>6s}  name")
        for name, (ms, n) in names[:args.top]:
            print(f"{n:6d} {ms:10.3f} {100 * ms / total:6.1f}  {name[:90]}")
    return out


if __name__ == "__main__":
    main()
