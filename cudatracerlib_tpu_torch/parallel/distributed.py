"""Multi-process bring-up over torch.distributed, and rank meshes (port of
cudatracerlib_tpu/parallel/distributed.py).

Every process runs the same program and owns one rank. A rank on the card
drives one GPU; ranks that each have their own GPU talk over NCCL, CPU ranks
(and ranks that share one card) over gloo. The collectives of
parallel/shard.py run over the mesh's process group, whatever the backend.

  * `init_distributed` starts the process group when the environment
    (torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK) or
    the caller's arguments say this is a multi-process job, and is a no-op
    otherwise or when a group is already live;
  * `host_mesh` lays the ranks out as a ("dp", "sp") DeviceMesh, rank-major
    with `sp` innermost, as the JAX package lays out its devices: the rank of
    mesh position (dp, sp) is dp * n_sp + sp;
  * `run_ranks` spawns a local job of n ranks (the `spawn` start method, a
    free port, a deadline on every rank) and returns each rank's result; a
    rank that raises fails the call with its own traceback.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 300.0


def _timedelta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     master_addr: str | None = None, master_port: int | None = None,
                     local_rank: int | None = None, *, device="cuda",
                     backend: str | None = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent multi-process bring-up. Returns True iff a process group
    is live afterwards.

    The arguments default to torchrun's environment variables; without a
    rank and a world size from either, this is a single-process run and
    nothing starts. The backend defaults to NCCL on the card and gloo on the
    CPU; pass backend="gloo" for ranks that share one card. A CUDA rank sets
    its device to its local rank (modulo the cards present, so gloo ranks
    may share one); NCCL needs a card per rank. `timeout` (seconds) bounds
    the rendezvous and every collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None or world_size is None:
        return False  # single-process run
    master_addr = master_addr or env.get("MASTER_ADDR")
    master_port = master_port or env.get("MASTER_PORT")
    if master_addr is None or master_port is None:
        raise ValueError("a multi-process job needs MASTER_ADDR and MASTER_PORT "
                         "(or master_addr and master_port)")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') found no CUDA device; "
                               "pass device='cpu' for CPU ranks")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(f"NCCL needs a card per rank: local rank {local_rank} of "
                               f"{n_cards} cards; pass backend='gloo' to share a card")
        torch.cuda.set_device(local_rank % n_cards)
    elif backend == "nccl":
        raise ValueError("NCCL ranks run on the card: pass device='cuda' or backend='gloo'")
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}:{int(master_port)}",
                            rank=rank, world_size=world_size, timeout=_timedelta(timeout))
    return True


def _rank_device(device="cuda") -> torch.device:
    """This rank's device: its current card for a CUDA rank, else the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def host_mesh(n_sp: int = 1, device="cuda"):
    """("dp", "sp") DeviceMesh over every rank of the live process group:
    (world // n_sp, n_sp), rank-major, `sp` innermost."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    n = dist.get_world_size()
    if n % n_sp:
        raise ValueError(f"{n} ranks do not split into sp = {n_sp}")
    return init_device_mesh(torch.device(device).type, (n // n_sp, n_sp),
                            mesh_dim_names=("dp", "sp"))


def process_topology() -> dict:
    """Small report of the distributed layout (for logs / bench output).
    Each rank drives one device."""
    live = dist.is_initialized()
    n = dist.get_world_size() if live else 1
    return {
        "process_index": dist.get_rank() if live else 0,
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
        "backend": dist.get_backend() if live else None,
        "cards": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }


def sync_hosts(timeout: float = 120.0) -> None:
    """Barrier: every rank reaches it before any proceeds, within `timeout`
    seconds. A no-op in a single-process run."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dist.barrier(async_op=True).wait(timeout=_timedelta(timeout))


def free_port() -> int:
    """A localhost TCP port that was free a moment ago (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, port, device, backend, timeout, fn, args, results):
    torch.set_num_threads(1)
    init_distributed(rank, n_ranks, "127.0.0.1", port, rank, device=device, backend=backend,
                     timeout=timeout)
    try:
        value = fn(rank, _rank_device(device), *args)
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    else:
        results.put((rank, value, None))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, args=(), *, device="cuda", backend: str | None = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(rank, device, *args)` on `n_ranks` spawned ranks of a local
    job and return their results in rank order. `fn` and `args` must
    pickle (a module-level function). CUDA ranks take NCCL when each has a
    card of its own and gloo when they share; CPU ranks take gloo. Every
    rank runs one torch thread. A rank that raises fails the call with its
    traceback (every failed rank's, the first to fail first); a job that
    outlives `timeout` seconds is terminated."""
    if backend is None:
        own_cards = torch.device(device).type == "cuda" and n_ranks <= torch.cuda.device_count()
        backend = "nccl" if own_cards else "gloo"
    results = mp.get_context("spawn").Queue()
    job = mp.start_processes(
        _rank_main, args=(n_ranks, free_port(), device, backend, timeout, fn, args, results),
        nprocs=n_ranks, join=False, start_method="spawn")
    out, failures = {}, []

    def drain(wait):
        try:  # a rank exits only once its result is read
            rank, value, tb = results.get(timeout=wait)
        except queue.Empty:
            return False
        if tb is None:
            out[rank] = value
        else:
            failures.append(f"rank {rank}:\n{tb}")
        return True

    deadline = time.monotonic() + timeout
    try:
        done = False
        while not done:
            if drain(0.2):
                continue
            done = job.join(timeout=0.2)
            if not done and time.monotonic() > deadline:
                raise TimeoutError(f"{n_ranks} ranks did not finish within {timeout} s")
    except mp.ProcessRaisedException as e:
        while drain(1.0):
            pass
        # the first rank to fail leads: the others' errors are usually its echo
        raise RuntimeError("".join(failures) or str(e)) from e
    finally:
        for p in job.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    while len(out) < n_ranks and drain(5.0):
        pass
    if len(out) != n_ranks:
        raise RuntimeError(f"ranks {sorted(set(range(n_ranks)) - set(out))} returned nothing")
    return [out[r] for r in range(n_ranks)]
