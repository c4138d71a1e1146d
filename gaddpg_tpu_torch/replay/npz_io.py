"""Reference-format .npz import/export for offline datasets (counterpart
of gaddpg_tpu/replay/npz_io.py).

The reference trains offline from a single `data_50k.npz` holding the
whole buffer attribute dump (reference: core/replay_memory.py:274-356).
The same keys are read and written, in the same dtypes, so a file
written by either package loads in the other. Host-side numpy.
"""

import os
from typing import Optional

import numpy as np
import torch

from gaddpg_tpu_torch.replay.buffer import ReplayBuffer, create_buffer

_SAVE_KEYS = (
    "action", "point_state", "reward", "terminal", "timestep", "returns",
    "state_pose", "collide", "collide_future", "grasp", "perturb_flags",
    "goal", "expert_flags", "expert_action", "target_idx", "episode_map",
)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def save_npz(buf: ReplayBuffer, path: str):
    """Dump the buffer's live transitions (the reference dumps full
    preallocated arrays, which makes mostly empty multi-GB files; the
    loader accepts either). `episode_map` is saved as uint32, as the JAX
    package stores it. A ring sharded over a mesh raises: each rank holds
    only its slots' points."""
    if buf.mesh is not None:
        raise ValueError("save_npz takes a one-rank ring, not a shard of a sharded one")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = max(int(buf.filled), 1)
    save = {k: _numpy(getattr(buf, k)[:n]) for k in _SAVE_KEYS}
    save["episode_map"] = save["episode_map"].astype(np.uint32)
    # image-mode buffers carry real (C, H, W) frames; point-cloud-only
    # buffers use a (1, 1, 1) placeholder that is not worth a dump.
    # f16 on disk halves the file (frames are [0, 1] RGB + metric depth)
    img = buf.image_state
    if img.dim() == 4 and tuple(img.shape[1:]) != (1, 1, 1):
        save["image_state"] = _numpy(img[:n]).astype(np.float16)
    save["is_full"] = bool(buf.is_full)
    save["filled"] = int(buf.filled)
    save["cur_idx"] = int(buf.cur_idx)
    save["total_env_step"] = int(buf.total_env_step)
    np.savez(path, **save)


def load_npz(path: str, buffer_size: Optional[int] = None, num_points: int = 1030,
             device="cuda") -> ReplayBuffer:
    """Load a reference-format buffer dump into a ReplayBuffer on `device`
    (raises without a card unless device="cpu").

    Recomputes nothing: the reference re-derives returns on load
    (reference: :321), but exported files already carry consistent
    returns. Point states wider or narrower than `num_points` are cut or
    zero-padded; (N, 1, 6) actions (the reference's layout) are taken
    as (N, 6); dumps without `collide_future` get it backfilled from
    `collide` and `episode_map`."""
    data = np.load(path, allow_pickle=True)
    n = int(np.amax(data["episode_map"])) + 1 if "episode_map" in data else len(data["reward"])
    size = buffer_size or max(n, 1)
    img_shape = None
    if "image_state" in data:
        ish = tuple(np.asarray(data["image_state"]).shape[1:])
        if len(ish) == 3 and ish != (1, 1, 1):
            img_shape = ish
    buf = create_buffer(size, num_points=num_points, image_shape=img_shape, device=device)

    load_keys = _SAVE_KEYS + (("image_state",) if img_shape else ())
    for k in load_keys:
        if k not in data:
            continue
        src = np.asarray(data[k])
        if src.ndim == 0:
            continue
        m = min(size, src.shape[0])
        dst = getattr(buf, k)
        if k == "point_state" and src.shape[-1] != dst.shape[-1]:
            p = min(src.shape[-1], dst.shape[-1])
            dst[:m, :, :p] = torch.as_tensor(src[:m, :, :p].astype(np.float32)).to(dst)
        elif k in ("action", "expert_action") and src.ndim == 3:
            dst[:m] = torch.as_tensor(src[:m, 0].astype(np.float32)).to(dst)
        else:
            dst[:m] = torch.as_tensor(src[:m].astype(np.float32 if dst.is_floating_point()
                                                     else np.int64)).to(dst)

    if "collide_future" not in data and "collide" in data and "episode_map" in data:
        # datasets saved before the collision-aware losses: backfill
        # collide_future[i] = any collide in [i, episode_map[i]]
        col = np.asarray(data["collide"], np.float32)
        ep_end = np.asarray(data["episode_map"], np.int64)
        fut = col.copy()
        for i in range(len(col) - 2, -1, -1):
            if ep_end[i] > i:
                fut[i] = max(col[i], fut[i + 1])
        m = min(size, len(fut))
        buf.collide_future.zero_()
        buf.collide_future[:m] = torch.as_tensor(fut[:m]).to(buf.collide_future)

    cur = int(data["cur_idx"]) if "cur_idx" in data else n
    if "filled" in data:
        filled = int(data["filled"])
    elif bool(data.get("is_full", False)):
        filled = size
    else:
        filled = cur
    buf.cur_idx = min(cur, size)
    buf.filled = min(filled, size)
    buf.total_env_step = int(data.get("total_env_step", n))
    return buf
