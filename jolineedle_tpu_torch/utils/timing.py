"""Timing helpers of the bench scripts: the card's name and a median time.

On the card a time is the device's, by a pair of CUDA events around each
call; on the CPU (the scripts' small modes, where the plain versions run)
it is the host clock's, and every row that carries it names the device as
``cpu``, never a card.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card(device) -> str:
    """``name, power limit`` of the card as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; ``cpu`` off the card."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, device) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls after one warm
    call. On the card: a CUDA event pair around each call, with a sleep
    kernel first so that the host queues every call ahead of the device
    and the events time the device, not the host's enqueue."""
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def back_to_back_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``launches`` calls queued back to back
    between one pair of CUDA events (median of ``reps``): what a launch
    costs inside a stream of kernels, without an event pair around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)
