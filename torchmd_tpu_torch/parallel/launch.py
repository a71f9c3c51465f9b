"""Spawn the ranks of a process group and run functions on all of them.

`Ranks(world_size, backend)` starts `world_size` processes with the
`spawn` start method (CUDA does not survive `fork`), each of which
initialises `torch.distributed` over TCP on localhost (a free port,
chosen by the parent) and then waits for work. `ranks.run(fn, *args)`
calls `fn(rank, *args)` on every rank at once and returns the results in
rank order; `fn` and its arguments and results are pickled, so `fn` is a
module-level function of an importable module. A rank's exception fails
the call with that rank's traceback; a call that does not finish within
its `timeout` fails too. Either way every rank is stopped: nothing is
swallowed and no process outlives the pool. The pool is a context
manager, and one pool serves many calls (the CPU tests spawn one per
world size and file).

A rank sets `torch.set_num_threads(threads)` when `threads` is given, and
with `device` (for example "cuda:0", which gloo ranks sharing one card
use) `torch.cuda.set_device` before the group forms.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import traceback

__all__ = ["Ranks", "free_port"]


def free_port() -> int:
    """A TCP port on localhost that nothing listened on a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, backend, port, threads, device, tasks, results):
    """A rank's loop: join the group, then run each task until None."""
    import torch
    import torch.distributed as dist

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device is not None and str(device).startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world_size, rank=rank)
    except Exception:  # reported to the parent, which fails the pool
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(rank, *args)))
            except Exception:  # the rank's failure goes to the parent
                results.put((rank, False, traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class Ranks:
    """A pool of `world_size` ranks in one process group (see the module
    docstring). `timeout` (s) bounds the start and each `run`."""

    def __init__(self, world_size, backend="gloo", threads=None, device=None,
                 timeout=600.0):
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        port = free_port()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.world_size, backend, port, threads, device,
                              self._tasks[r], self._results))
            for r in range(self.world_size)]
        for p in self._procs:
            p.start()
        try:
            self._collect("start")
        except BaseException:
            self.close()
            raise

    def _collect(self, what):
        """One message from every rank: their results in rank order. A
        rank's error, a rank that died without a word, or the timeout
        fails the call."""
        import queue
        import time

        out, seen = [None] * self.world_size, set()
        deadline = time.monotonic() + self.timeout
        while len(seen) < self.world_size:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in seen and p.exitcode is not None]
                if dead:
                    # a last look: a rank writes its error before it exits
                    try:
                        rank, ok, value = self._results.get(timeout=2.0)
                    except queue.Empty:
                        codes = {r: self._procs[r].exitcode for r in dead}
                        raise RuntimeError(f"parallel.launch: ranks {codes} (rank: exit "
                                           f"code) died in {what}") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"parallel.launch: {what} did not finish on every "
                                       f"rank within {self.timeout} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"parallel.launch: rank {rank} failed in {what}:\n{value}")
            out[rank] = value
            seen.add(rank)
        return out

    def run(self, fn, *args):
        """fn(rank, *args) on every rank; the results in rank order."""
        if self._procs is None:
            raise RuntimeError("parallel.launch: the pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        try:
            return self._collect(getattr(fn, "__name__", repr(fn)))
        except BaseException:
            self.close()
            raise

    def close(self):
        """Stop every rank (politely, then by force) and reap it."""
        if self._procs is None:
            return
        import queue
        import time

        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        # drain what the ranks still write while they stop (joining a
        # process with unread queue data can deadlock), for at most 10 s
        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

