"""Furthest point sampling, ball query and grouping (batched over clouds).

Counterpart of `gaddpg_tpu/ops/sampling.py` and of the Pallas kernels in
`gaddpg_tpu/ops/pallas_kernels.py`. The JAX functions take one cloud and
are vmapped; here the batch dimension is written out: xyz is (B, N, 3).

`furthest_point_sampling` and `ball_query` are the kernel wrappers: a CPU
tensor runs `fps_reference` / `ball_query_reference`, a CUDA tensor
launches the CUDA kernel (`csrc/fps.cu`, `csrc/ball_query.cu`) or raises.
Each wrapper counts its kernel launches in its `launches` attribute.

Squared distances are summed as dx*dx + dy*dy + dz*dz, each operation
rounded on its own, in the Pallas kernels' order and never through the
|a|^2 + |b|^2 - 2ab expansion, so the kernels and the plain versions pick
the same indices bit for bit.
"""

import numpy as np
import torch

from gaddpg_tpu_torch.ops import build


def _sq_dist(a, b):
    """|a - b|^2 over the last axis (size 3), broadcasting, in the
    kernels' rounding order."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def _radius_sq(radius: float) -> float:
    """radius**2 rounded to float32 once, as the JAX code's weakly typed
    `radius * radius` comparison does."""
    return float(np.float32(radius * radius))


def _check_points(name: str, t: torch.Tensor):
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(
            f"{name} must be float32 of shape (B, N, 3); got {t.dtype} {tuple(t.shape)}"
        )


def fps_reference(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) -> (B, npoint) int32 indices.

    Starts at index 0 with a 1e10 min-distance register; argmax ties go
    to the lowest index (torch.argmax returns the first maximum)."""
    b, n, _ = xyz.shape
    dist = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = _sq_dist(xyz, xyz[rows, last][:, None, :])
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=-1)
        idx[:, i] = last.to(torch.int32)
    return idx


def furthest_point_sampling(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32 for xyz (B, N, 3) float32.

    CPU tensor: `fps_reference`. CUDA tensor: the K1 kernel, one warp per
    cloud holding the cloud in shared memory at 16 bytes a point, so N is
    bounded by one block's shared memory (14,528 points)."""
    _check_points("xyz", xyz)
    b, n, _ = xyz.shape
    if n < 1 or npoint < 1:
        raise ValueError(f"need N >= 1 and npoint >= 1; got N={n}, npoint={npoint}")
    dev = build.kernel_device("furthest_point_sampling", xyz)
    if dev.type == "cpu":
        return fps_reference(xyz, npoint)
    if 16 * n > build.MAX_SMEM_BYTES:
        raise ValueError(f"furthest_point_sampling: N={n} exceeds shared memory")
    out = torch.empty((b, npoint), dtype=torch.int32, device=dev)
    build.launch("fps", dev, xyz.data_ptr(), b, n, npoint, out.data_ptr())
    furthest_point_sampling.launches += 1
    return out


furthest_point_sampling.launches = 0


def ball_query_reference(centers: torch.Tensor, xyz: torch.Tensor, radius: float,
                         nsample: int) -> torch.Tensor:
    """Plain PyTorch ball query: (B, S, 3) centres, (B, N, 3) points ->
    (B, S, nsample) int32.

    The first `nsample` points with d2 <= r^2 in index order; free slots
    (also when nsample > N) repeat the first hit; a centre with no hit
    gets its nearest point (lowest index on ties) in every slot."""
    n = xyz.shape[-2]
    d2 = _sq_dist(centers[:, :, None, :], xyz[:, None, :, :])  # (B, S, N)
    in_ball = d2 <= _radius_sq(radius)
    order = torch.arange(n, device=xyz.device)
    # hits keep their index, misses sort after every hit
    key = torch.where(in_ball, order, n + order)
    picked = torch.topk(key, min(nsample, n), dim=-1, largest=False, sorted=True).values
    if nsample > n:
        picked = torch.nn.functional.pad(picked, (0, nsample - n), value=n)
    idx = torch.where(picked < n, picked, picked[..., :1])
    nearest = torch.argmin(d2, dim=-1, keepdim=True)
    idx = torch.where(in_ball.any(dim=-1, keepdim=True), idx, nearest)
    return idx.to(torch.int32)


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, S, nsample) int32 ball-query indices of xyz (B, N, 3) around
    centers (B, S, 3), both float32.

    CPU tensors: `ball_query_reference`. CUDA tensors: the K2 kernel."""
    _check_points("centers", centers)
    _check_points("xyz", xyz)
    b, s, _ = centers.shape
    n = xyz.shape[1]
    if xyz.shape[0] != b or n < 1 or nsample < 1:
        raise ValueError(
            f"ball_query: centers {tuple(centers.shape)}, xyz {tuple(xyz.shape)}, "
            f"nsample {nsample}"
        )
    dev = build.kernel_device("ball_query", centers, xyz)
    if dev.type == "cpu":
        return ball_query_reference(centers, xyz, radius, nsample)
    out = torch.empty((b, s, nsample), dtype=torch.int32, device=dev)
    build.launch("ball_query", dev, centers.data_ptr(), xyz.data_ptr(), b, s, n,
                 _radius_sq(radius), nsample, out.data_ptr())
    ball_query.launches += 1
    return out


ball_query.launches = 0


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C) indexed with idx (B, ...) -> (B, ..., C)."""
    b = points.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def group_points(xyz, feats, centers_idx, group_idx):
    """Grouped features for set abstraction.

    xyz (B, N, 3); feats (B, N, C); centers_idx (B, S); group_idx (B, S, K).
    Returns new_xyz (B, S, 3) and grouped (B, S, K, 3 + C), whose first 3
    channels are centre-relative offsets (pointnet2 `use_xyz=True`)."""
    new_xyz = gather_points(xyz, centers_idx)
    g_xyz = gather_points(xyz, group_idx) - new_xyz[:, :, None, :]
    return new_xyz, torch.cat([g_xyz, gather_points(feats, group_idx)], dim=-1)
