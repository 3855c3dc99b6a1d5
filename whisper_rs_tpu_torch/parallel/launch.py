"""Start ranks as processes of this host and collect what they return.

``run_ranks(fn, world, backend, device, args, timeout)`` spawns ``world``
processes (``torch.multiprocessing``, start method ``spawn``), each of
which starts the default process group with ``initialize_multihost`` over
a ``file://`` rendezvous in a temporary directory of its own (no port to
race for; ``coordinator`` names a ``host:port`` or URL instead), runs
``fn(rank, *args)`` and sends back its picklable return value.  Where a
rank raises, exits without an answer or the timeout passes, every rank is
killed and ``RuntimeError`` carries the first failure.  ``fn`` must be
importable by name from a module (spawn pickles it by reference).
``Ranks`` is the same in two halves: its constructor returns once every
rank has started, and ``wait()`` collects, for a caller with work of its
own to do meanwhile.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_module
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world: int, backend: str, device: str, init: str, args,
               results, threads) -> None:
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        import torch
        import torch.distributed as dist

        from .distributed import initialize_multihost

        if threads:
            torch.set_num_threads(threads)
        initialize_multihost(init, world, rank, backend, device=device)
        try:
            out = fn(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        # by value: a tensor put on the queue as it is travels as a file
        # descriptor of this process, which is gone when the parent reads it
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """``world`` spawned ranks of one process group (``backend``, ``device``
    for its default) running ``fn(rank, *args)``; ``wait()`` returns their
    results in rank order.  Every rank has started once the constructor
    returns, each with this process's environment as it was then, so the
    caller may go on (and change ``os.environ``) while they run.
    ``threads`` sets each rank's ``torch.set_num_threads`` (0: torch's
    default)."""

    def __init__(self, fn, world: int, backend: str = "gloo", device: str = "cpu", args=(),
                 threads: int = 1, coordinator: str | None = None):
        ctx = mp.get_context("spawn")
        self.world, self.results, self.procs = world, ctx.Queue(), []
        self.start = time.monotonic()
        self._tmp = tempfile.TemporaryDirectory(prefix="whisper-ranks-")
        init = coordinator or f"file://{os.path.join(self._tmp.name, 'rendezvous')}"
        try:
            for r in range(world):
                self.procs.append(ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(fn, r, world, backend, device, init, args, self.results, threads)))
                self.procs[-1].start()
        except BaseException:
            self._stop(kill=True)
            raise

    def _stop(self, kill: bool) -> None:
        for p in self.procs:
            if kill and p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()

    def wait(self, timeout: float = 300.0) -> list:
        """The ranks' results, ``timeout`` seconds from their start at most;
        every rank is killed and ``RuntimeError`` raised on a failure."""
        procs, world = self.procs, self.world
        out, deadline, failure = {}, self.start + timeout, None
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, value = self.results.get(timeout=1.0)
                except queue_module.Empty:
                    if time.monotonic() > deadline:
                        failure = f"ranks {sorted(set(range(world)) - set(out))} did not finish " \
                                  f"within {timeout} s"
                    elif any(p.exitcode not in (None, 0) for p in procs):
                        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                        failure = f"ranks {dead} exited with codes " \
                                  f"{[procs[r].exitcode for r in dead]} and no answer"
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            self._stop(kill=failure is not None or len(out) < world)
        if failure is not None:
            raise RuntimeError(failure)
        return [out[r] for r in range(world)]


def run_ranks(fn, world: int, backend: str = "gloo", device: str = "cpu", args=(),
              timeout: float = 300.0, threads: int = 1, coordinator: str | None = None) -> list:
    """``Ranks(fn, world, ...).wait(timeout)``: ``fn(rank, *args)`` on
    ``world`` spawned ranks; their results in rank order."""
    return Ranks(fn, world, backend, device, args, threads, coordinator).wait(timeout)
