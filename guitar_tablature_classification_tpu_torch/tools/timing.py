"""Timing shared by the port's tools."""

from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after one warm-up:
    CUDA events around the calls on the card (the device's time, ending in
    a synchronize), the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
