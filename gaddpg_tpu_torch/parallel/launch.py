"""Start the ranks of a data-parallel run (GSPMD needs no launcher; a
process per rank does).

    results = launch(fn, world=2, args=(x,), devices=["cpu"] * 2)

runs fn(mesh, *args) in `world` spawned processes, rank r on devices[r]
(default cuda:r), and returns their return values in rank order. The
ranks meet at a `file://` rendezvous in a directory of their own (a fresh
temporary one unless `rendezvous_dir` is given), so launches in parallel
test files never compete for a port. The backend follows the devices:
gloo on the CPU, NCCL with a card a rank, gloo with host-staged CUDA
tensors where several ranks share a card (`mesh.init_mesh`).

Nothing hangs: the process group has a timeout, the whole launch has
one, and when a rank raises or dies the others are killed and
`RankFailure` carries the first failure's traceback.
"""

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
import uuid

import torch

from gaddpg_tpu_torch.parallel import mesh as mesh_lib

DEFAULT_TIMEOUT_S = 600.0


class RankFailure(RuntimeError):
    """A rank raised, died or did not finish within the launch's timeout."""


def _child(rank, world, device, shared_card, init_method, timeout_s, threads, fn, args,
           results):
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = mesh_lib.init_mesh(world, rank, device, init_method, shared_card=shared_card,
                                  timeout_s=timeout_s)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- the rank ends here; the parent raises it
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # no teardown: the other ranks may be blocked in a collective
    mesh_lib.shutdown()


def rank_devices(world: int, device: str = "cuda", ranks_per_card: int = 1):
    """Rank -> device: all "cpu", or rank r on cuda:(r // ranks_per_card)."""
    if device == "cpu":
        return ["cpu"] * world
    return [f"cuda:{r // ranks_per_card}" for r in range(world)]


def launch(fn, world: int, args=(), devices=None, rendezvous_dir=None,
           timeout_s: float = DEFAULT_TIMEOUT_S, threads=None):
    """Run fn(mesh, *args) on `world` ranks and return their results in
    rank order. `fn` must be importable by name (a module-level function)
    and `args` and the results picklable. `devices`: one per rank
    (default cuda:r); `threads`: torch's CPU threads a rank (default 1
    on CPU ranks, torch's own on CUDA ranks). Raises RankFailure with the
    first failing rank's traceback, or when `timeout_s` passes; every
    rank is stopped before it returns or raises."""
    devices = [str(d) for d in (devices or rank_devices(world))]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    shared_card = len(set(devices)) < world and devices[0] != "cpu"
    if threads is None and all(d == "cpu" for d in devices):
        threads = 1
    if rendezvous_dir is None:
        rendezvous_dir = tempfile.mkdtemp(prefix="gaddpg_rdv_")
    init_method = "file://" + os.path.join(os.path.abspath(rendezvous_dir),
                                           f"rendezvous-{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, devices[r], shared_card, init_method, timeout_s,
                               threads, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    done, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                waiting = [r for r in range(world) if r not in done]
                failure = f"ranks {waiting} did not finish within {timeout_s:.0f} s"
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    try:  # its message may have arrived as it exited
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no traceback")
                        break
                else:
                    continue
            if ok:
                done[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=0 if failure else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
    if failure is not None:
        raise RankFailure(failure)
    return [done[r] for r in range(world)]
