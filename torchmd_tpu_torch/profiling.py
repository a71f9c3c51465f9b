"""Profiling / observability helpers (the port's counterpart of
`torchmd_tpu.profiling`).

  - `StepTimer`: wall-clock throughput accounting for MD loops
    (steps/sec, ns/day given a timestep), each measured block bracketed
    by `torch.cuda.synchronize()` on a CUDA device, so the time covers
    the device's work and not only its enqueue.
  - `trace(logdir)`: `torch.profiler` (CPU and, with a card, CUDA
    activities) around the enclosed block, written as a Chrome trace
    (`trace.json`) into `logdir`; the CLI's `--profile`.
  - `block_timed(fn, *args)`: time one call including device sync.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    def __init__(self, timestep_fs: float | None = None, device=None):
        self.timestep_fs = timestep_fs
        self.device = device
        self.reset()

    def reset(self):
        self.steps = 0
        self.elapsed = 0.0

    @contextlib.contextmanager
    def measure(self, nsteps: int):
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.elapsed += time.perf_counter() - t0
        self.steps += nsteps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def ns_per_day(self) -> float | None:
        if self.timestep_fs is None or not self.elapsed:
            return None
        return self.steps_per_sec * self.timestep_fs * 1e-6 * 86400.0

    def summary(self) -> dict:
        out = {"steps": self.steps, "elapsed_s": self.elapsed,
               "steps_per_sec": self.steps_per_sec}
        if self.ns_per_day is not None:
            out["ns_per_day"] = self.ns_per_day
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed block, exported to
    `logdir/trace.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def block_timed(fn, *args, device=None, **kwargs):
    """(result, seconds) with a device sync before and after the call."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(device)
    return out, time.perf_counter() - t0
