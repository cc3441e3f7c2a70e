"""Time a training recipe on the card: its pace, tests, wall time and memory.

Runs a command (a recipe script of this directory, e.g.
``run_sup_flagship.sh``), echoes its output with each line stamped by the
seconds since the start, samples ``nvidia-smi`` meanwhile, and prints one
JSON line at the end:

    python -m jolineedle_tpu_torch.scripts.time_recipe --log runs/sup.log \\
        -- sh jolineedle_tpu_torch/scripts/run_sup_flagship.sh runs/sup yolox-s

The JSON line holds the card's name and power limit, the command's exit
code and wall seconds, the seconds per iteration (the median over the
spans between two printed iterations that hold no test), the seconds of
each test cycle (a span's excess over that pace), the final validation's
seconds (from the last printed iteration to the end: the iterations after
it, the best checkpoint's reload and the full test), the peak of
``memory.used`` that ``nvidia-smi`` reported (the caching allocator's
reservation and the context, above ``max_memory_allocated``) and its
highest power draw, and the CLI's own closing lines: its peak
``max_memory_allocated`` and its kernels' launches. Needs an NVIDIA GPU
and ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ITER_LINE = re.compile(r"^iter (\d+): loss ")
PEAK_LINE = re.compile(r"^peak device memory: ")
LAUNCH_LINE = "kernel launches: "
SAMPLE_EVERY_S = 5.0  # between nvidia-smi samples


def query_gpu(fields: str) -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in out.strip().splitlines()]


def sample_memory(stop: threading.Event, every: float, samples: list) -> None:
    while not stop.wait(every):
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,power.draw",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            samples.append([float(v) for v in out.stdout.splitlines()[0].split(",")])


def pace(iters: list, test_every: int) -> dict:
    """Seconds per iteration and per test from ``(iteration, seconds)``
    stamps: spans that cross a multiple of ``test_every`` hold a test."""
    clean, tested = [], []
    for (i0, t0), (i1, t1) in zip(iters, iters[1:]):
        span = ((t1 - t0) / (i1 - i0), i0, i1, t1 - t0)
        (tested if test_every and i1 // test_every > i0 // test_every else clean).append(span)
    s_iter = statistics.median(s for s, *_ in clean) if clean else None
    tests = [round(dt - s_iter * (i1 - i0), 3) for _, i0, i1, dt in tested] if s_iter else []
    return {"s_per_iter": s_iter, "s_per_iter_spans": len(clean), "test_s": tests}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log", type=Path, required=True,
                        help="file for the stamped output (its folder is made)")
    parser.add_argument("--test-every", type=int, default=2500,
                        help="the recipe's --test-every: the spans that hold a test")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the command, after --")
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no command given")
    card = query_gpu("name,power.limit")[0]
    print(card, flush=True)
    args.log.parent.mkdir(parents=True, exist_ok=True)

    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_memory, args=(stop, SAMPLE_EVERY_S, samples),
                               daemon=True)
    iters, peak_line, launches = [], None, None
    start = time.perf_counter()
    sampler.start()
    try:
        with open(args.log, "w") as log:
            proc = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
            for line in proc.stdout:
                now = time.perf_counter() - start
                log.write(f"[{now:10.3f}] {line}")
                sys.stdout.write(line)
                match = ITER_LINE.match(line)
                if match:
                    iters.append((int(match.group(1)), now))
                if PEAK_LINE.match(line):
                    peak_line = line.strip()
                if line.startswith(LAUNCH_LINE):
                    launches = json.loads(line[len(LAUNCH_LINE):])
            rc = proc.wait()
    finally:
        stop.set()
        sampler.join(timeout=30)
    wall = time.perf_counter() - start
    result = {"card": card, "command": command, "rc": rc, "wall_s": round(wall, 3),
              **pace(iters, args.test_every),
              "final_s": round(wall - iters[-1][1], 3) if iters else None,
              "peak_memory_used_mib": max((s[0] for s in samples), default=None),
              "max_power_draw_w": max((s[1] for s in samples), default=None),
              "trainer_peak": peak_line, "kernel_launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main()["rc"])
