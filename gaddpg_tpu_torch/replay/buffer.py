"""Fixed-shape replay ring buffer (counterpart of gaddpg_tpu/replay/buffer.py).

Semantics mirror `BaseMemory` (reference: core/replay_memory.py), as the
JAX package keeps them:
- flat transition storage with an `episode_map` pointing every index at
  its episode's last transition (reference: :230),
- discounted-return backfill at insert time (reference: :223-228),
- `sample` draws uniform indices in [episode_max_len, upper) and builds
  next-state views via `min(episode_map[i], i+1)` (reference: :251-266),
- remaining-time feature = timestep[episode_end] + 1 - timestep[i]
  (reference: :266),
- optional on-policy goal relabelling from stored hand poses
  (reference: :233-249).

The storage is a dataclass of tensors on one device; the three cursors
are host integers. The JAX package inserts a batch of episodes through a
scan of single-episode inserts. Here `add_episodes` copies the (E, T)
validity mask to the host once, runs the sequential ring rule there
(cheap: E integers), and writes every field with one indexed store whose
rows keep the scan's outcome: where a later episode of the same call
overwrites a slot, the later one is what the store writes.

Under a data-parallel mesh (`create_buffer(..., mesh=)`) the ring shards
on its capacity axis as the JAX package's `shard_leading_axis` lays it
out: slot j of `point_state` and `image_state` lives on rank
j // (size / n). The per-slot scalars, poses and actions (every other
field, a few hundred bytes a slot) are replicated, so that every rank
runs the ring rule and the next-state and episode-end lookups itself.
`add_episodes` gathers every rank's masks and small fields and sends
each rank the point rows and frames its slots take (`all_to_all_rows`);
`sample` draws the global indices on every rank alike, keeps this rank's
B / n and fetches their points and frames (and next ones) from the
ranks that own them, the bfloat16 frames as their bytes.
`gather_buffer` returns the whole ring.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gaddpg_tpu_torch.geometry.se3 import pack_pose_rot_first, se3_inverse
from gaddpg_tpu_torch.parallel.mesh import (
    all_gather_rows, all_to_all_rows, local_slice, validate_dp_divisibility, world_of,
)
from gaddpg_tpu_torch.utils.precision import f32_matmuls, resolve_device


@dataclasses.dataclass
class ReplayBuffer:
    # transition storage
    point_state: torch.Tensor      # (S, 4, P) point cloud state
    image_state: torch.Tensor      # (S, 5, H, W) RGBDM; (S, 1, 1, 1) disabled
    action: torch.Tensor           # (S, 6)
    expert_action: torch.Tensor    # (S, 6)
    reward: torch.Tensor           # (S,)
    returns: torch.Tensor          # (S,)
    terminal: torch.Tensor         # (S,)
    timestep: torch.Tensor         # (S,)
    state_pose: torch.Tensor       # (S, 4, 4) hand pose in world
    goal: torch.Tensor             # (S, 7) [q, t] grasp goal in hand frame
    expert_flags: torch.Tensor     # (S,)
    perturb_flags: torch.Tensor    # (S,)
    collide: torch.Tensor          # (S,)
    collide_future: torch.Tensor   # (S,) any collision at/after this step
    grasp: torch.Tensor            # (S,)
    target_idx: torch.Tensor       # (S,)
    episode_map: torch.Tensor      # (S,) int64 index of episode end
    # cursors (host integers)
    cur_idx: int = 0               # next write position
    filled: int = 0                # high-water mark of live data
    total_env_step: int = 0
    # the data-parallel mesh the capacity axis shards over (None: one rank)
    mesh: object = None

    @property
    def size(self) -> int:
        """The ring's capacity (over every rank's shard)."""
        return self.episode_map.shape[0]

    @property
    def is_full(self) -> bool:
        return self.filled >= self.size

    @property
    def device(self) -> torch.device:
        return self.point_state.device

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel() * getattr(self, f.name).element_size()
                   for f in dataclasses.fields(self) if f.name in TENSOR_FIELDS)


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(ReplayBuffer)
                      if f.name not in ("cur_idx", "filled", "total_env_step", "mesh"))
# the fields sharded on the capacity axis under a mesh; the others are replicated
SHARDED_FIELDS = ("point_state", "image_state")


def create_buffer(size: int, num_points: int = 1030, image_shape=None,
                  device="cuda", mesh=None) -> ReplayBuffer:
    """An empty float32 ring of `size` transitions on `device` (raises
    without a card unless device="cpu"). `image_shape` (C, H, W) enables
    RGBDM storage, in bfloat16 as the JAX package stores it. With a
    data-parallel `mesh` (`size` a multiple of its ranks) this rank holds
    its size / n slots of the point and image states."""
    device = resolve_device(device)
    validate_dp_divisibility(mesh, buffer_size=size)
    local = size // world_of(mesh)
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return ReplayBuffer(
        point_state=f(local, 4, num_points),
        image_state=(torch.zeros((local, *image_shape), dtype=torch.bfloat16, device=device)
                     if image_shape else f(local, 1, 1, 1)),
        action=f(size, 6),
        expert_action=f(size, 6),
        reward=f(size),
        returns=f(size),
        terminal=f(size),
        timestep=f(size),
        state_pose=torch.eye(4, dtype=torch.float32, device=device).repeat(size, 1, 1),
        goal=f(size, 7),
        expert_flags=f(size),
        perturb_flags=f(size),
        collide=f(size),
        collide_future=f(size),
        grasp=f(size),
        target_idx=f(size),
        episode_map=torch.zeros(size, dtype=torch.int64, device=device),
        mesh=mesh,
    )


_EP_FIELDS = (
    "point_state", "image_state", "action", "expert_action", "reward",
    "terminal", "timestep", "state_pose", "goal", "expert_flags",
    "perturb_flags", "collide", "grasp", "target_idx",
)


def _ring_rows(buf: ReplayBuffer, valid: np.ndarray):
    """The sequential ring rule of the JAX `add_episode`, run on the host
    over E episodes: -> (source rows into the flattened (E*T) episodes,
    their compacted positions, destination slots, episode-end slots, the
    new cursors). A later episode's write to a slot replaces an earlier
    one's, as in the scan; rows whose slot lies past the ring are
    dropped."""
    e_count, t_count = valid.shape
    size = buf.size
    cur, filled, total = buf.cur_idx, buf.filled, buf.total_env_step
    src, pos, dst, end = [], [], [], []
    for e in range(e_count):
        live = np.flatnonzero(valid[e])
        n = len(live)
        start = 0 if cur + n > size else cur
        src.append(e * t_count + live)
        pos.append(e * t_count + np.arange(n))
        dst.append(start + np.arange(n))
        end.append(np.full(n, start + n - 1))
        cur = start + n
        filled = max(filled, cur)
        total += n
    src, pos, dst, end = (np.concatenate(a) if a else np.zeros(0, np.int64)
                          for a in (src, pos, dst, end))
    keep = dst < size
    src, pos, dst, end = src[keep], pos[keep], dst[keep], end[keep]
    # the last write to each slot wins
    _, last = np.unique(dst[::-1], return_index=True)
    rows = np.sort(len(dst) - 1 - last)
    return src[rows], pos[rows], dst[rows], end[rows], (cur, filled, total)


def _compact_sequences(values: torch.Tensor, valid: torch.Tensor, gamma: float):
    """Per episode (rows of (E, T)): the rewards and collisions compacted
    valid-first, then the discounted returns backfilled from the last
    live step and the reverse running max of collisions."""
    e_count, t_count = valid.shape
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    n_valid = valid.sum(dim=1, keepdim=True)
    live = torch.arange(t_count, device=valid.device)[None] < n_valid
    out = {}
    for k, v in values.items():
        out[k] = torch.where(live, torch.gather(v, 1, order), 0.0)
    rew = out.pop("reward")
    returns = torch.zeros_like(rew)
    carry = torch.zeros(e_count, dtype=rew.dtype, device=rew.device)
    for i in range(t_count - 1, -1, -1):
        r = rew[:, i] + gamma * carry
        carry = torch.where(live[:, i], r, 0.0)
        returns[:, i] = carry
    out["returns"] = returns
    if "collide" in out:
        col = out.pop("collide")
        out["collide_future"] = torch.flip(torch.cummax(torch.flip(col, [1]), dim=1).values, [1])
    return out


@torch.no_grad()
def add_episodes(buf: ReplayBuffer, episodes: Dict[str, torch.Tensor], valid: torch.Tensor,
                 gamma: float = 0.95) -> ReplayBuffer:
    """Insert a batch of fixed-length episodes (E, T, ...) masked by
    `valid` (E, T), in env order, into `buf` in place; returns it.

    Per episode the valid transitions are compacted to the front,
    preserving their order; the discounted return is backfilled from the
    last valid reward; `collide_future[i]` is the largest collision flag
    in [i, episode end]; `episode_map` points at the episode's final
    slot. An episode never straddles the ring boundary: when it would
    not fit in [cur_idx, size) its write restarts at 0 (reference:
    core/replay_memory.py:193-199). Fields absent from `episodes` (e.g.
    image_state in point-cloud runs) keep their contents. Under a mesh
    the episodes are this rank's envs' (every rank calls it), inserted
    as the envs of every rank in rank order."""
    valid = valid.to(buf.device, torch.bool)
    mesh = buf.mesh
    e_local, t_count = valid.shape
    valid = all_gather_rows(mesh, valid)
    e_count = valid.shape[0]
    src, pos, dst, end, cursors = _ring_rows(buf, valid.cpu().numpy())
    dev = buf.device
    d_src, d_pos, d_dst, d_end = (torch.as_tensor(a, dtype=torch.int64).to(dev)
                                  for a in (src, pos, dst, end))

    small = {k: episodes[k] for k in _EP_FIELDS if k in episodes and k not in SHARDED_FIELDS}
    small = _gather_fields(mesh, small, e_local, t_count)
    seq = {"reward": small["reward"].to(dev, torch.float32)}
    if "collide" in small:
        seq["collide"] = small["collide"].to(dev, torch.float32)
    derived = _compact_sequences(seq, valid, gamma)

    for k, x in small.items():
        flat = x.reshape(e_count * t_count, *x.shape[2:])
        target = getattr(buf, k)
        target[d_dst] = flat.to(dev)[d_src].to(target.dtype)
    for k in SHARDED_FIELDS:
        if k in episodes:
            x = episodes[k]
            _store_rows(buf, getattr(buf, k), x.reshape(e_local * t_count, *x.shape[2:]),
                        src, dst, e_local * t_count)
    for k, v in derived.items():
        target = getattr(buf, k)
        target[d_dst] = v.reshape(-1)[d_pos].to(target.dtype)
    buf.episode_map[d_dst] = d_end
    buf.cur_idx, buf.filled, buf.total_env_step = cursors
    return buf


def _gather_fields(mesh, fields: Dict[str, torch.Tensor], e_local: int, t_count: int):
    """Every rank's (E_local, T, ...) fields concatenated in rank order
    (one all-gather of their float32 columns under a mesh)."""
    if mesh is None or not fields:
        return fields
    cols = {k: v.reshape(e_local, t_count, -1) for k, v in fields.items()}
    packed = torch.cat([c.to(torch.float32) for c in cols.values()], dim=-1)
    packed = all_gather_rows(mesh, packed)
    out, offset = {}, 0
    for k, c in cols.items():
        width = c.shape[-1]
        x = packed[..., offset:offset + width]
        out[k] = x.reshape(packed.shape[0], t_count, *fields[k].shape[2:]).to(fields[k].dtype)
        offset += width
    return out


def _store_rows(buf: ReplayBuffer, target: torch.Tensor, rows: torch.Tensor, src, dst,
                rows_per_rank: int):
    """target[dst - shard start] = row src of the episodes' flattened rows,
    for the slots in this rank's shard. Under a mesh `rows` are this
    rank's envs' (rows_per_rank of them) and each goes to the rank that
    owns its slot."""
    dev = target.device
    mesh = buf.mesh
    if mesh is None:
        d_src, d_dst = (torch.as_tensor(a, dtype=torch.int64).to(dev) for a in (src, dst))
        target[d_dst] = rows.to(dev)[d_src].to(target.dtype)
        return
    local = buf.size // mesh.world
    src_rank, dst_rank = src // rows_per_rank, dst // local
    mine = src_rank == mesh.rank
    # the rows this rank sends, grouped by the rank that stores them
    order = np.flatnonzero(mine)[np.argsort(dst_rank[mine], kind="stable")]
    send_counts = np.bincount(dst_rank[mine], minlength=mesh.world)
    recv = dst_rank == mesh.rank
    recv_counts = np.bincount(src_rank[recv], minlength=mesh.world)
    send_idx = torch.as_tensor(src[order] - mesh.rank * rows_per_rank).to(dev)
    got = all_to_all_rows(mesh, rows.to(dev)[send_idx].to(target.dtype), send_counts,
                          recv_counts)
    # received in order of the sending rank, each block in insert order
    slots = np.concatenate([dst[recv & (src_rank == q)] for q in range(mesh.world)])
    target[torch.as_tensor(slots - mesh.rank * local).to(dev)] = got


def gather_buffer(buf: ReplayBuffer) -> Dict[str, torch.Tensor]:
    """The whole ring as one tensor per field (every rank calls it under a
    mesh; the sharded fields are gathered from every rank)."""
    return {k: all_gather_rows(buf.mesh, getattr(buf, k)) if k in SHARDED_FIELDS
            else getattr(buf, k) for k in TENSOR_FIELDS}


def _fetch_rows(buf: ReplayBuffer, field: torch.Tensor, want: np.ndarray) -> torch.Tensor:
    """Rows `want` (every rank's requests, (n, per_rank) slots, the same
    array on every rank) of a sharded field: each rank gets its own
    request row's slots from the ranks that own them."""
    mesh = buf.mesh
    dev = field.device
    local = buf.size // mesh.world
    owner = want // local
    me = mesh.rank
    send = [np.flatnonzero(owner[q] == me) for q in range(mesh.world)]
    send_slots = np.concatenate([want[q][i] for q, i in enumerate(send)]) - me * local
    rows = field[torch.as_tensor(send_slots).to(dev)]
    recv_counts = [int((owner[me] == q).sum()) for q in range(mesh.world)]
    got = all_to_all_rows(mesh, rows, [len(i) for i in send], recv_counts)
    # put the rows back in request order: block q holds the slots rank q owns
    order = np.concatenate([np.flatnonzero(owner[me] == q) for q in range(mesh.world)])
    out = torch.empty_like(got)
    out[torch.as_tensor(order).to(dev)] = got
    return out


def add_episode(buf: ReplayBuffer, episode: Dict[str, torch.Tensor], valid: torch.Tensor,
                gamma: float = 0.95) -> ReplayBuffer:
    """Insert one fixed-length episode (T, ...) masked by `valid` (T,)."""
    return add_episodes(buf, {k: v[None] for k, v in episode.items()}, valid[None], gamma)


def upper_idx(buf: ReplayBuffer) -> int:
    """Exclusive upper bound of live data (high-water mark)."""
    return max(buf.filled, 1)


@torch.no_grad()
@f32_matmuls
def sample(buf: ReplayBuffer, batch_size: int, episode_max_len: int = 20,
           onpolicy_goal: bool = False, generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A uniform batch with next-state indexing (reference: :166-176,
    :251-272). The indices are drawn in [lo, upper) with lo =
    min(episode_max_len, upper - 1), from `generator` (a generator of the
    buffer's device; None = torch's default one), unless given as `idx`
    (batch_size,) integers. Under a mesh `batch_size` and `idx` are the
    global batch's, drawn alike on every rank, and the rows returned are
    this rank's batch_size / n of them."""
    upper = upper_idx(buf)
    lo = min(episode_max_len, upper - 1)
    dev = buf.device
    mesh = buf.mesh
    if idx is None:
        idx = torch.randint(0, max(upper - lo, 1), (batch_size,), generator=generator,
                            device=dev) + lo
    else:
        idx = torch.as_tensor(idx).to(dev, torch.int64)
    nxt_all = torch.minimum(buf.episode_map[idx], idx + 1)
    mine = local_slice(mesh, idx.shape[0])
    fields = ["point_state"]
    if buf.image_state.shape[-1] > 1:  # image storage enabled
        fields.append("image_state")
    if mesh is None:
        rows = {k: (getattr(buf, k)[idx], getattr(buf, k)[nxt_all]) for k in fields}
    else:
        # the global idx and nxt of every rank's rows, fetched from their owners
        n = mesh.world
        want = np.concatenate([idx.cpu().numpy().reshape(n, -1),
                               nxt_all.cpu().numpy().reshape(n, -1)], axis=1)
        rows = {k: _fetch_rows(buf, getattr(buf, k), want).chunk(2) for k in fields}
    idx, nxt = idx[mine], nxt_all[mine]
    ep_end = buf.episode_map[idx]

    goal = buf.goal[idx]
    next_goal = buf.goal[nxt]
    if onpolicy_goal:
        # HER-style relabel for non-expert steps: goal = pose_now^-1 @ pose_end
        end_pose = buf.state_pose[ep_end]
        rel = se3_inverse(buf.state_pose[idx]) @ end_pose
        rel_n = se3_inverse(buf.state_pose[nxt]) @ end_pose
        mask = (buf.expert_flags[idx] == 0.0)[:, None]
        goal = torch.where(mask, pack_pose_rot_first(rel), goal)
        next_goal = torch.where(mask, pack_pose_rot_first(rel_n), next_goal)

    out = {}
    if "image_state" in rows:
        frames, next_frames = rows["image_state"]
        out = {"image_state": frames.to(torch.float32),
               "next_image_state": next_frames.to(torch.float32)}
    out.update({
        "point_state": rows["point_state"][0],
        "next_point_state": rows["point_state"][1],
        "action": buf.action[idx],
        "expert_action": buf.expert_action[idx],
        "next_action": buf.action[nxt],
        "reward": buf.reward[idx],
        "return": buf.returns[idx],
        "next_return": buf.returns[nxt],
        "terminal": buf.terminal[idx],
        # remaining timesteps (reference: core/replay_memory.py:266)
        "time": buf.timestep[ep_end] + 1.0 - buf.timestep[idx],
        "goal": goal,
        "next_goal": next_goal,
        "expert_flags": buf.expert_flags[idx],
        "perturb_flags": buf.perturb_flags[idx],
        "collide": buf.collide[idx],
        "collide_future": buf.collide_future[idx],
        "batch_idx": idx,
    })
    return out
