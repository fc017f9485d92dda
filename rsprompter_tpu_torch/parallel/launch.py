"""Run a function on N ranks of one host without torchrun.

torchrun is how a user launches data parallelism (``tools.train``,
``tools.test``). Checks that compare N ranks with one process in the same
program (the CPU tests over gloo, ``chip_smoke.py``'s two ranks on one card
over gloo) start the ranks here instead: spawned processes (not forked:
the caller has imported torch, which runs threads) that meet at a
``file://`` rendezvous of their own, so concurrent callers never collide on
a port. The function's arguments reach the ranks through a file beside the
rendezvous: sent down spawn's pipe, a large argument would hold the caller
until each child had imported what it needs to unpickle it.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch.multiprocessing as mp

from rsprompter_tpu_torch.parallel import distributed


def _rank_entry(rank: int, fn: Callable, world: int, args_file: str, device: str,
                backend: Optional[str], init_file: str, threads: int, results) -> None:
    import torch

    with open(args_file, "rb") as f:
        args = pickle.load(f)  # written by the caller below
    if threads:
        torch.set_num_threads(threads)
    distributed.initialize(device, backend=backend, init_method=f"file://{init_file}",
                           world_size=world, rank=rank, timeout_s=600)
    try:  # bytes, not tensors: a shared tensor's file handle dies with its rank
        results.put((rank, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, pickle.dumps(RuntimeError(f"rank {rank}:\n{traceback.format_exc()}"))))
        raise
    finally:
        distributed.shutdown()


class Ranks:
    """Ranks started by :func:`start_ranks`; :meth:`join` waits for their
    results. The caller may work meanwhile (the ranks are processes of
    their own)."""

    def __init__(self, fn: Callable, world: int, args: Sequence, device: str,
                 backend: Optional[str], threads: int, timeout_s: float):
        self.world = world
        self.deadline = time.monotonic() + timeout_s
        self._tmp = tempfile.TemporaryDirectory(prefix="rendezvous-")
        self._results = mp.get_context("spawn").Queue()
        args_file = os.path.join(self._tmp.name, "args.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(tuple(args), f)
        self._procs = mp.start_processes(
            _rank_entry, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, args_file, device, backend,
                  os.path.join(self._tmp.name, "init"), threads, self._results))

    def join(self) -> List[Any]:
        """Each rank's result, in rank order. Raises with a rank's traceback
        if one fails, or once the deadline has passed; the ranks are gone
        either way."""
        out: dict = {}
        try:
            while len(out) < self.world:  # drain before joining: a full pipe blocks its writer
                try:
                    rank, blob = self._results.get(timeout=1.0)
                except queue.Empty:
                    self._procs.join(timeout=0.01)  # raises where a rank died
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{self.world} ranks did not finish in time")
                    continue
                value = pickle.loads(blob)  # written by the ranks above
                if isinstance(value, BaseException):
                    raise value
                out[rank] = value
            while not self._procs.join(timeout=1.0):  # True once every rank has exited
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.world} ranks did not exit in time")
        finally:
            for p in self._procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
            self._tmp.cleanup()
        return [out[r] for r in range(self.world)]


def start_ranks(fn: Callable, world: int, args: Sequence = (), device: str = "cpu",
                backend: Optional[str] = None, threads: int = 0,
                timeout_s: float = 900.0) -> Ranks:
    """Start ``fn(*args)`` on ``world`` spawned ranks in one process group
    (gloo on the CPU, NCCL on ``cuda`` unless ``backend`` says otherwise;
    ``device`` ``'cuda:0'`` puts every rank on card 0). ``fn`` must be
    importable by name and return picklable values (tensors on the CPU).
    ``threads`` > 0 sets each rank's torch threads; ``timeout_s`` bounds
    the whole run."""
    return Ranks(fn, world, args, device, backend, threads, timeout_s)


def run_ranks(fn: Callable, world: int, args: Sequence = (), **kwargs) -> List[Any]:
    """:func:`start_ranks`, then :meth:`Ranks.join`."""
    return start_ranks(fn, world, args, **kwargs).join()
