"""Data-parallel ranks and their collectives (counterpart of
gaddpg_tpu/parallel/mesh.py).

The JAX package shards one global program over a 1-D "dp" mesh and
GSPMD derives the collectives. Here every rank is a process of its own
(`parallel.launch` starts them) running the same program on its rows:
the env batch, the replay ring's capacity and the update's batch split
over the ranks, while the parameters, targets and Adam moments stay
replicated. What GSPMD does implicitly is written out:

- every random draw is drawn for the global batch from a generator in
  the same state on every rank, and each rank keeps its own rows
  (`draw_rows`), so rank r's envs and rows see what envs
  [r * b, (r + 1) * b) see in the one-rank run;
- BatchNorm statistics are sums reduced across the ranks between the
  layers (`all_reduce_sum`, differentiable: its backward is the same
  all-reduce of the incoming gradients);
- a loss is each rank's sum over its rows divided by the global count,
  and the flat gradients are summed across ranks before each optimizer
  step (`sum_grads`).

Every sum across ranks is an all-gather followed by an add in rank
order, so every rank gets the same bits and a reduction does not
depend on the backend's algorithm. Every collective is reached by every
rank in the same order: none sits under a branch on a rank's own rows.

Backends: NCCL for CUDA ranks with a card each, gloo on the CPU, and
gloo with CUDA tensors staged through host memory when several ranks
share a card (`Mesh.staged`), which NCCL refuses.
"""

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a 1-D data-parallel mesh: `world` ranks,
    this one `rank`, its `device`, the process `group` (None: the
    default group) and whether CUDA tensors go through host memory for
    the collectives (`staged`)."""
    world: int
    rank: int
    device: torch.device
    group: object = None
    staged: bool = False

    @property
    def is_lead(self) -> bool:
        """Rank 0, the one that logs and writes checkpoints."""
        return self.rank == 0


def init_mesh(world: int, rank: int, device, init_method: str, shared_card: bool = False,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the process group of `world` ranks at `init_method` as `rank`,
    running on `device`: NCCL with a card a rank, gloo on the CPU or with
    ranks sharing a card (`shared_card`; NCCL refuses two ranks on one
    device). Returns the mesh (`make_mesh`). Raises ValueError when the
    device names a card that does not exist, and RuntimeError when CUDA
    is asked for without one; a rank never carries on elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} is to run on {device}, but CUDA is not available")
        index = 0 if device.index is None else device.index
        count = torch.cuda.device_count()
        if index >= count:
            raise ValueError(f"rank {rank} is to run on cuda:{index}, but only {count} card(s) "
                             "are visible")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = "nccl" if device.type == "cuda" and not shared_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(world, device)


def make_mesh(n_ranks: Optional[int] = None, device=None) -> Mesh:
    """The mesh of this process in the running process group (`init_mesh`
    starts one; `parallel.launch` calls it in every rank), on `device`
    (default: the current card under NCCL, the CPU under gloo). Raises
    ValueError without a process group, or when the group has other than
    the `n_ranks` asked for: a rank cannot be left out of a group's
    collectives, so a mesh is never truncated."""
    if not dist.is_initialized():
        raise ValueError(
            f"requested a {n_ranks or 'data-parallel'}-rank mesh but no process group is "
            "running; start the ranks with gaddpg_tpu_torch.parallel.launch")
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"requested a {n_ranks}-rank mesh but the process group has "
                         f"{world} rank(s); a mesh takes every rank of its group")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    return Mesh(world=world, rank=dist.get_rank(), device=device, group=dist.group.WORLD,
                staged=backend == "gloo" and device.type == "cuda")


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_of(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


def validate_dp_divisibility(mesh: Optional[Mesh], **named_sizes) -> None:
    """Raise early when a leading-axis size does not divide over the
    mesh, before anything is built. Call with the batch-like sizes that
    shard on the dp axis, e.g. validate_dp_divisibility(mesh,
    num_envs=64, batch_size=256); a no-op without a mesh."""
    if mesh is None:
        return
    n = mesh.world
    bad = {k: v for k, v in named_sizes.items() if v % n != 0}
    if bad:
        raise ValueError(
            f"sizes not divisible by the {n}-rank mesh: "
            + ", ".join(f"{k}={v} ({v} % {n} = {v % n})" for k, v in bad.items())
            + " -- pick multiples of the rank count so every shard is equal"
        )


# -- rows --------------------------------------------------------------------------

def local_slice(mesh: Optional[Mesh], total: int) -> slice:
    """This rank's rows of a leading axis of `total` (all without a mesh)."""
    if mesh is None:
        return slice(0, total)
    if total % mesh.world:
        raise ValueError(f"a leading axis of {total} does not split over {mesh.world} ranks")
    b = total // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_leading_axis(mesh: Optional[Mesh], tree):
    """This rank's rows of every tensor or array in `tree` (dicts, lists
    and tuples of them; anything else, 0-d values included, as it is);
    the tree itself without a mesh."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_leading_axis(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_leading_axis(mesh, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim:
        return tree[local_slice(mesh, tree.shape[0])]
    return tree


def draw_rows(mesh: Optional[Mesh], draw, shape):
    """`draw(shape)` for this rank's rows: the draw is made for the global
    batch (the leading axis times the ranks) from a generator in the same
    state on every rank, and this rank's rows are kept, so the generators
    stay in step and every row sees the one-rank run's values."""
    if mesh is None:
        return draw(tuple(shape))
    shape = tuple(shape)
    full = draw((shape[0] * mesh.world, *shape[1:]))
    return full[mesh.rank * shape[0]:(mesh.rank + 1) * shape[0]]


# -- collectives -------------------------------------------------------------------

def _out(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the backend takes it: on the host for staged CUDA tensors;
    booleans as bytes (gloo has no bool); bfloat16 (the ring's frames) as
    its bytes, the last axis twice as long, so that a move is exact
    whatever the backend does with bfloat16 (gloo refuses int16)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.staged and x.is_cuda:
        x = x.cpu()
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        x = x.view(torch.bfloat16)
    return x.to(like.device, like.dtype)


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (same shape on every rank) concatenated in rank
    order along the leading axis; x itself without a mesh."""
    if mesh is None:
        return x
    src = _out(mesh, x)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return _back(torch.cat(parts, dim=0), x)


def sum_over_ranks(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's x, added in rank order, the same bits on
    every rank (not differentiable; `all_reduce_sum` is). bfloat16, which
    moves as its bytes, is not summed."""
    if mesh is None:
        return x
    if x.dtype == torch.bfloat16:
        raise TypeError("sum_over_ranks: cast bfloat16 to float32 before summing")
    src = _out(mesh, x)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return _back(total, x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return sum_over_ranks(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        # d(sum_r x_r)/dx_q = 1 for every q: each rank's gradient is the
        # sum of every rank's incoming one
        return None, sum_over_ranks(ctx.mesh, grad.contiguous())


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's x, differentiable: the backward sums the
    incoming gradients across the ranks. x itself without a mesh."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(mesh, x)


def all_to_all_rows(mesh: Mesh, x: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
    """Rows of x, laid out by destination rank (`send_counts[q]` rows for
    rank q, in rank order), exchanged: returns the rows this rank
    receives, `recv_counts[q]` from rank q, in rank order."""
    send_counts = [int(c) for c in send_counts]
    recv_counts = [int(c) for c in recv_counts]
    src = _out(mesh, x)
    out = torch.empty((sum(recv_counts), *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_to_all_single(out, src, recv_counts, send_counts, group=mesh.group)
    return _back(out, x)


def broadcast_(mesh: Optional[Mesh], tensors, src: int = 0):
    """Overwrite `tensors` (a list) in place with rank `src`'s, through one
    flat buffer per dtype; a no-op without a mesh."""
    if mesh is None:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _out(mesh, torch.cat([t.detach().reshape(-1) for t in group]))
        dist.broadcast(flat, src, group=mesh.group)
        flat = _back(flat, group[0])
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return tensors


def replicate(mesh: Optional[Mesh], tensors, check: bool = False):
    """Make `tensors` (a list) rank 0's on every rank. With `check`, raise
    RuntimeError where a rank's own values differed from rank 0's (the
    ranks were to build the same values)."""
    if mesh is None:
        return tensors
    before = [t.detach().clone() for t in tensors] if check else None
    broadcast_(mesh, tensors)
    if check:
        same = all(torch.equal(a, b) for a, b in zip(before, tensors))
        flags = sum_over_ranks(mesh, torch.tensor([0 if same else 1], dtype=torch.int64))
        if int(flags[0]):
            raise RuntimeError(f"{int(flags[0])} rank(s) built values other than rank 0's")
    return tensors


def sum_grads(mesh: Optional[Mesh], grads, params):
    """The gradients (aligned with `params`; None counts as zero) summed
    across the ranks through one flat all-reduce; as they are without a
    mesh."""
    if mesh is None:
        return grads
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params, strict=True)])
    flat = sum_over_ranks(mesh, flat)
    out, offset = [], 0
    for p in params:
        out.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return out


def make_sharded_update(update_fn, mesh: Mesh):
    """Wrap an update built for `mesh` (`make_ddpg_update(cfg, device,
    mesh=mesh)` or `make_bc_update`) so that it takes the global batch:
    `run(state, batch, *args, **kwargs)` keeps this rank's rows of the
    batch and of `noise_draws`, and the update sums its gradients across
    the ranks; the state stays replicated."""
    if getattr(update_fn, "mesh", None) is not mesh:
        raise ValueError("make_sharded_update: build the update with mesh=<this mesh>")

    def run(state, batch, *args, **kwargs):
        batch = shard_leading_axis(mesh, batch)
        if kwargs.get("noise_draws") is not None:
            kwargs["noise_draws"] = shard_leading_axis(mesh, kwargs["noise_draws"])
        return update_fn(state, batch, *args, **kwargs)

    return run
