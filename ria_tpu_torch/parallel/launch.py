"""Start N ranks of one program and collect what each returns.

JAX's tests shard over virtual devices inside one process; torch has one
device per rank, so a mesh here is a set of processes.  :func:`launch` is
the one way this package starts them (tests, ``entry.dryrun_multichip``,
``tools/scaling_bench.py`` and ``chip_smoke.py``):

- processes are started with ``spawn`` (CUDA cannot follow a ``fork``), so
  the target is a module-level function, pickled by its import path, and its
  arguments are pickled too, into one file per rank in the launch's own
  temporary directory (a process's start then sends only a path);
  ``rank_args[r]`` goes to rank r only, so each rank is sent only its own
  block or rows;
- the ranks meet through a ``FileStore`` in a temporary directory of their
  own, so two launches at once (two test workers) never meet on a port;
- rank r runs on ``cuda:{r % device_count}`` (``device="cpu"``: the CPU,
  with one thread each); the kernels are built in the parent first, so the
  ranks do not start one ``nvcc`` each;
- the parent's deadline ends every rank when it expires, and raises naming
  the ranks that did not finish; a rank's exception is raised again in the
  parent with the rank's traceback as a note; a rank that dies without a
  result raises too;
- results come back with every tensor as a numpy array.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ria_tpu_torch.parallel import distributed
from ria_tpu_torch.utils.device import resolve_device

# Seconds the parent waits for the ranks to exit after the last result.
_EXIT_GRACE_S = 30.0


def to_numpy(x):
    """``x`` with every tensor, at any depth of tuples (named ones kept),
    lists and dicts, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str,
               timeout_s: float, work: str, results) -> None:
    try:
        with open(work, "rb") as f:
            target, args = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
        # Collectives wait longer than the parent's deadline, so a rank that
        # never arrives is reported by the parent, not by its peers' timeouts.
        distributed.initialize(init_method, world, rank, backend=backend, device=device,
                               timeout_s=timeout_s + _EXIT_GRACE_S)
        out = to_numpy(target(*args))
    except BaseException as exc:  # reported to the parent, which raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(exc)
        except Exception:  # noqa: BLE001 - an exception that cannot travel
            exc = RuntimeError(repr(exc))
        results.put((rank, False, (exc, tb)))
        return
    results.put((rank, True, out))
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(target, world_size: int, args: tuple = (), rank_args=None,
           device: str | torch.device = "cuda", backend: str | None = None,
           timeout_s: float = 120.0) -> list:
    """``[target(*args, *rank_args[r]) for r in range(world_size)]``, each
    on its own rank, with every tensor of the results as a numpy array.

    ``backend`` None picks :func:`distributed.choose_backend` (all ranks on
    this host).  Raises the first exception a rank raised (its traceback in
    a note), ``TimeoutError`` when ranks are still running after
    ``timeout_s`` seconds, and ``RuntimeError`` for a rank that exits with
    no result; every rank is ended either way."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ria_tpu_torch.utils import cuda_kernels

        cuda_kernels.build()
    backend = backend or distributed.choose_backend(dev, world_size)
    rank_args = rank_args or [()] * world_size
    if len(rank_args) != world_size:
        raise ValueError(f"{len(rank_args)} rank_args for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ria_launch_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = []
        for r in range(world_size):
            work = os.path.join(tmp, f"rank{r}.pkl")
            with open(work, "wb") as f:
                pickle.dump((target, tuple(args) + tuple(rank_args[r])), f)
            procs.append(ctx.Process(target=_rank_main, daemon=True,
                                     args=(r, world_size, init, backend, dev.type, timeout_s,
                                           work, results)))
        for p in procs:
            p.start()
        try:
            got = _collect(procs, results, time.monotonic() + timeout_s, timeout_s)
            for p in procs:
                p.join(_EXIT_GRACE_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
    return [got[r] for r in range(world_size)]


def _silent_deaths(procs, reported, wait_s: float) -> list[int]:
    """The ranks that exited with a failing code and no report, waiting up
    to ``wait_s`` for one to show.  (A rank that exits with 0 has put its
    report, which may still be in the queue.)"""
    end = time.monotonic() + wait_s
    while True:
        dead = [r for r, p in enumerate(procs) if r not in reported and p.exitcode]
        if dead or time.monotonic() >= end:
            return dead
        time.sleep(0.05)


def _collect(procs, results, deadline: float, timeout_s: float) -> dict:
    got: dict = {}
    reported: set = set()
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(len(procs)) if r not in got]
            raise TimeoutError(f"ranks {missing} of {len(procs)} did not finish within "
                               f"{timeout_s:g} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = _silent_deaths(procs, reported, 0.0)
            if not dead:
                continue
            raise _died(procs, dead[0])
        reported.add(rank)
        if not ok:
            exc, tb = payload
            exc.add_note(f"raised on rank {rank} of {len(procs)}:\n{tb}")
            # A peer's collective fails when a rank dies: report the death.
            dead = _silent_deaths(procs, reported, 2.0)
            if dead:
                raise _died(procs, dead[0]) from exc
            raise exc
        got[rank] = payload
    return got


def _died(procs, rank: int) -> RuntimeError:
    return RuntimeError(f"rank {rank} exited with code {procs[rank].exitcode} and no result")
