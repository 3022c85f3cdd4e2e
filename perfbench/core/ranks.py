"""Local jobs of ranks for the sharded cells. This process is rank 0 and
ranks 1 .. n-1 are spawned (the `spawn` start method), so whatever watches
this process (a profiler, a reader, perfbench/tools/span_breakdown.py) sees
rank 0's run as its own.

Every rank calls `module.function(rank, *args)`, the function looked up by
name (the spawned ranks import `module` afresh). The spawned ranks put
(rank, result, traceback) on a queue, drained after rank 0's own call
returns; a spawned rank that fails, or a job past its deadline, fails the
call with the rank's traceback. While rank 0 works, a watch thread reads the
queue too: on a spawned rank's failure it prints the traceback and ends this
process (exit code 3), since rank 0 may then wait in a collective that no
peer will join."""
from __future__ import annotations

import importlib
import os
import queue
import sys
import threading
import time
import traceback

import torch.multiprocessing as mp


def _child(rank, module, function, args, results):
    try:
        value = getattr(importlib.import_module(module), function)(rank, *args)
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    results.put((rank, value, None))


def run(n_ranks: int, module: str, function: str, args=(), *, timeout: float = 900.0,
        watch: bool = True) -> list:
    """[module.function(rank, *args) for rank in 0 .. n_ranks-1], rank 0 run
    here; with `watch`, a spawned rank's failure ends this process."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, module, function, args, results), daemon=True)
             for r in range(1, n_ranks)]
    for p in procs:
        p.start()
    out, failed, done = {}, [], threading.Event()

    def take(wait):
        rank, value, tb = results.get(timeout=wait)
        if tb is None:
            out[rank] = value
        else:
            failed.append(f"rank {rank}:\n{tb}")

    def watcher():
        while not done.is_set():
            try:
                take(0.5)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not done.is_set():
                    failed.append(f"rank {procs.index(dead[0]) + 1} exited with {dead[0].exitcode}")
            if failed and not done.is_set():
                print("".join(failed), file=sys.stderr, flush=True)
                os._exit(3)

    thread = threading.Thread(target=watcher, daemon=True) if watch else None
    try:
        if thread is not None:
            thread.start()
        out[0] = getattr(importlib.import_module(module), function)(0, *args)
        done.set()
        if thread is not None:
            thread.join()
        deadline = time.monotonic() + timeout
        while len(out) + len(failed) < n_ranks:
            try:
                take(1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and not failed:
                    failed.append("a spawned rank exited without a result")
                if failed or time.monotonic() > deadline:
                    break
        if failed or len(out) < n_ranks:
            raise RuntimeError("".join(failed) or f"ranks {sorted(set(range(n_ranks)) - set(out))} "
                               f"returned nothing within {timeout} s")
        return [out[r] for r in range(n_ranks)]
    finally:
        done.set()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(10)
