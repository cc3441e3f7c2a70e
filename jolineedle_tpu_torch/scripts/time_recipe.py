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
reservation and the context, above ``max_memory_allocated``), its
highest power draw, the SM and memory clocks it reported (median and
lowest, in MHz, beside the card's maximum SM clock), and the CLI's own
closing lines: its peak ``max_memory_allocated`` and its kernels'
launches. Needs an NVIDIA GPU and ``nvidia-smi``.

``--keep-last RUN_DIR DEST`` keeps the weights the run ends its training
with. The final validation reloads the best checkpoint and, at its end,
writes those weights over the last one (``checkpoint.pt``), as the JAX
package does; so when the CLI prints the line that starts it, the command's
process is paused, ``RUN_DIR``'s ``checkpoint.pt`` (the last test's
weights: the final iteration's when ``--max-iters`` is a multiple of
``--test-every``) and ``config.json`` are copied into ``DEST``, and the
process goes on. ``eval_checkpoint.py DEST --ckpt last`` then tests them.
The recipe scripts ``exec`` the CLI, so the command's process is the CLI's.

The JSON line also holds each test's single-start, multistart-2 and
detector mAP (``tests``, from the metrics the CLI prints after a test).
``--stop-after-tests N`` ends the command (SIGTERM) once it has printed N
tests' metrics: a probe of a recipe's curve that does not run its 20k
iterations (``sup_probe.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ITER_LINE = re.compile(r"^iter (\d+): loss ")
PEAK_LINE = re.compile(r"^peak device memory: ")
LAUNCH_LINE = "kernel launches: "
FINAL_VALIDATION_LINE = "Loading best checkpoint for validation"
TEST_KEYS = ("map", "map_multistart_2", "supervised_map")  # read from each test's metrics
SAMPLE_EVERY_S = 5.0  # between nvidia-smi samples
SAMPLED = "memory.used,power.draw,clocks.sm,clocks.mem"  # each sample's fields


def query_gpu(fields: str) -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in out.strip().splitlines()]


def sample_memory(stop: threading.Event, every: float, samples: list) -> None:
    while not stop.wait(every):
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SAMPLED}",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            try:
                samples.append([float(v) for v in out.stdout.splitlines()[0].split(",")])
            except ValueError:  # a field read "[N/A]"
                pass


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


def clocks(samples: list) -> dict:
    """The sampled SM and memory clocks (MHz): median and lowest, and the
    card's maximum SM clock."""
    try:
        out = {"max_sm_clock_mhz": float(query_gpu("clocks.max.sm")[0].split()[0])}
    except ValueError:  # "[N/A]"
        out = {"max_sm_clock_mhz": None}
    for i, name in ((2, "sm"), (3, "mem")):
        values = [s[i] for s in samples]
        out[f"{name}_clock_mhz"] = ({"median": statistics.median(values), "min": min(values)}
                                    if values else None)
    return out


def keep_last(pid: int, run_dir: Path, dest: Path) -> None:
    """Copy ``run_dir``'s last checkpoint and config into ``dest`` while the
    process ``pid`` is stopped."""
    os.kill(pid, signal.SIGSTOP)
    try:
        dest.mkdir(parents=True, exist_ok=True)
        for name in ("checkpoint.pt", "config.json"):
            shutil.copy2(run_dir / name, dest / name)
    finally:
        os.kill(pid, signal.SIGCONT)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log", type=Path, required=True,
                        help="file for the stamped output (its folder is made)")
    parser.add_argument("--test-every", type=int, default=2500,
                        help="the recipe's --test-every: the spans that hold a test")
    parser.add_argument("--keep-last", nargs=2, type=Path, metavar=("RUN_DIR", "DEST"),
                        help="copy RUN_DIR's last checkpoint and config into DEST when the"
                        " final validation starts")
    parser.add_argument("--stop-after-tests", type=int, default=None, metavar="N",
                        help="end the command once it has printed N tests' metrics")
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
    iters, peak_line, launches, kept = [], None, None, None
    tests, block = [], None  # the tests' metrics; the lines of the JSON being printed
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
                if args.keep_last and line.startswith(FINAL_VALIDATION_LINE):
                    keep_last(proc.pid, *args.keep_last)
                    kept = str(args.keep_last[1])
                if line == "{\n":
                    block = []
                if block is not None:
                    block.append(line)
                    if line == "}\n":
                        metrics, block = json.loads("".join(block)), None
                        if "map" in metrics:
                            tests.append({k: metrics.get(k) for k in TEST_KEYS})
                        if len(tests) == args.stop_after_tests:
                            proc.terminate()
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
              **clocks(samples),
              "trainer_peak": peak_line, "kernel_launches": launches, "tests": tests,
              **({"kept_last": kept} if args.keep_last else {})}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main()["rc"])
