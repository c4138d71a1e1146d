"""Furthest point sampling, ball query and grouping (batched over clouds).

Counterpart of `gaddpg_tpu/ops/sampling.py` and of the Pallas kernels in
`gaddpg_tpu/ops/pallas_kernels.py`. The JAX functions take one cloud and
are vmapped; here the batch dimension is written out: xyz is (B, N, 3).

`furthest_point_sampling` and `ball_query` are the kernel wrappers: a CPU
tensor runs `fps_reference` / `ball_query_reference`, a CUDA tensor
launches the CUDA kernel (`csrc/fps.cu`, `csrc/ball_query.cu`) or raises.
Each wrapper counts its kernel launches in its `launches` attribute.
A `valid=` mask selects the plain version on either device, as the JAX
package serves masked calls from its XLA path only: the kernels take no
mask, and the choice follows the argument, never a failure. The model's
calls pass no mask.

Squared distances are summed as dx*dx + dy*dy + dz*dz, each operation
rounded on its own, in the Pallas kernels' order and never through the
|a|^2 + |b|^2 - 2ab expansion, so the kernels and the plain versions pick
the same indices bit for bit.
"""

import functools

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


def _check_valid(valid, b: int, n: int, device):
    if valid.shape != (b, n) or valid.dtype != torch.bool or valid.device != device:
        raise ValueError(f"valid must be bool of shape ({b}, {n}) on {device}; got "
                         f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")


def fps_reference(xyz: torch.Tensor, npoint: int, valid=None) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) -> (B, npoint) int32 indices.

    Starts at index 0 with a 1e10 min-distance register; argmax ties go
    to the lowest index (torch.argmax returns the first maximum). `valid`
    (B, N) bool keeps padding points out of the selection: the argmax
    reads the register plus -1e10 where a point is invalid, as the JAX
    package's masked FPS does."""
    b, n, _ = xyz.shape
    dist = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    penalty = None if valid is None else torch.where(valid, 0.0, -1e10).to(torch.float32)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = _sq_dist(xyz, xyz[rows, last][:, None, :])
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist if penalty is None else dist + penalty, dim=-1)
        idx[:, i] = last.to(torch.int32)
    return idx


def furthest_point_sampling(xyz: torch.Tensor, npoint: int, valid=None) -> torch.Tensor:
    """FPS indices (B, npoint) int32 for xyz (B, N, 3) float32.

    CPU tensor: `fps_reference`. CUDA tensor: the K1 kernel, one warp per
    cloud holding the cloud in shared memory at 16 bytes a point, so N is
    bounded by one block's shared memory (14,528 points). With `valid`
    (B, N) bool, `fps_reference` on the tensor's device: the kernel takes
    no mask (gaddpg_tpu/ops/sampling.py:29 serves a mask from XLA)."""
    _check_points("xyz", xyz)
    b, n, _ = xyz.shape
    if n < 1 or npoint < 1:
        raise ValueError(f"need N >= 1 and npoint >= 1; got N={n}, npoint={npoint}")
    if valid is not None:
        _check_valid(valid, b, n, xyz.device)
        return fps_reference(xyz, npoint, valid)
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
                         nsample: int, valid=None) -> torch.Tensor:
    """Plain PyTorch ball query: (B, S, 3) centres, (B, N, 3) points ->
    (B, S, nsample) int32.

    The first `nsample` points with d2 <= r^2 in index order; free slots
    (also when nsample > N) repeat the first hit; a centre with no hit
    gets its nearest point (lowest index on ties) in every slot. `valid`
    (B, N) bool makes invalid points no hit; the nearest point of a
    centre without hits is taken over every point, as in the JAX
    package."""
    n = xyz.shape[-2]
    d2 = _sq_dist(centers[:, :, None, :], xyz[:, None, :, :])  # (B, S, N)
    in_ball = d2 <= _radius_sq(radius)
    if valid is not None:
        in_ball = in_ball & valid[:, None, :]
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


# K2's launch (csrc/ball_query.cu): warps per block, and the centres a
# block takes at most; fewer when the batch would leave SMs idle
BALL_QUERY_WARPS = 8
BALL_QUERY_CENTRES = 32


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ball_query_smem_bytes(centres: int, n: int, nsample: int) -> int:
    """Shared memory of one K2 block that takes `centres` centres of a
    cloud of n points (csrc/ball_query.cu `Layout`): a float4 per point
    and per centre, one 4-byte hit mask per centre and 32-point chunk (the
    chunk count made odd) and an nsample-slot row per half warp, each part
    rounded to 16 bytes."""
    r4 = lambda x: -(-x // 4) * 4
    mstride = -(-n // 32) | 1
    return 4 * (4 * n + 4 * centres + r4(centres * mstride) + 2 * BALL_QUERY_WARPS * r4(nsample))


def check_ball_query_smem(s: int, n: int, nsample: int) -> int:
    """Shared bytes of the smallest K2 block for S centres over clouds of
    N points (one centre); raises ValueError when even that exceeds one
    block's shared memory. Called before any launch."""
    if s < 1 or n < 1 or nsample < 1:
        raise ValueError(f"ball_query: need S, N, nsample >= 1; got {s}, {n}, {nsample}")
    smem = ball_query_smem_bytes(1, n, nsample)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"ball_query: N={n}, nsample={nsample} need {smem} bytes of shared "
                         f"memory a block, more than {build.MAX_SMEM_BYTES}")
    return smem


def ball_query_layout(b: int, s: int, n: int, nsample: int, sms: int):
    """(centres, shared bytes) of a K2 block for B clouds of N points with
    S centres each on a card of `sms` SMs: a block takes one cloud and
    BALL_QUERY_CENTRES of its centres, fewer when B * S centres would give
    under two blocks an SM (groups of equal size); halved until the block
    fits in shared memory."""
    check_ball_query_smem(s, n, nsample)
    per_block = max(1, min(BALL_QUERY_CENTRES, -(-b * s // (2 * sms))))
    centres = -(-s // -(-s // per_block))
    while ball_query_smem_bytes(centres, n, nsample) > build.MAX_SMEM_BYTES:
        centres = -(-centres // 2)
    return centres, ball_query_smem_bytes(centres, n, nsample)


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int, valid=None) -> torch.Tensor:
    """(B, S, nsample) int32 ball-query indices of xyz (B, N, 3) around
    centers (B, S, 3), both float32.

    CPU tensors: `ball_query_reference`. CUDA tensors: the K2 kernel,
    laid out by `ball_query_layout`; a cloud too large for one block's
    shared memory raises ValueError. With `valid` (B, N) bool,
    `ball_query_reference` on the tensors' device: the kernel takes no
    mask (gaddpg_tpu/ops/sampling.py:60 serves a mask from XLA)."""
    _check_points("centers", centers)
    _check_points("xyz", xyz)
    b, s, _ = centers.shape
    n = xyz.shape[1]
    if xyz.shape[0] != b or n < 1 or nsample < 1:
        raise ValueError(
            f"ball_query: centers {tuple(centers.shape)}, xyz {tuple(xyz.shape)}, "
            f"nsample {nsample}"
        )
    if valid is not None:
        if centers.device != xyz.device:
            raise ValueError(f"centers on {centers.device}, xyz on {xyz.device}")
        _check_valid(valid, b, n, xyz.device)
        return ball_query_reference(centers, xyz, radius, nsample, valid)
    dev = build.kernel_device("ball_query", centers, xyz)
    if dev.type == "cpu":
        return ball_query_reference(centers, xyz, radius, nsample)
    centres, _ = ball_query_layout(b, s, n, nsample, sm_count(dev.index))
    out = torch.empty((b, s, nsample), dtype=torch.int32, device=dev)
    build.launch("ball_query", dev, centers.data_ptr(), xyz.data_ptr(), b, s, n,
                 _radius_sq(radius), nsample, centres, out.data_ptr())
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


def regularize_point_count(pc: torch.Tensor, npoints: int, valid=None, generator=None,
                           draws=None):
    """Random up/down-sampling of clouds pc (B, N, C) to exactly `npoints`
    rows each -> (pc (B, npoints, C), idx (B, npoints) int64), as the
    JAX package's `regularize_point_count` (the reference's random-choice
    path, reference: core/utils.py:784-812), one cloud a row of B.

    A Gumbel top-k samples min(npoints, N) rows without replacement among
    the valid ones (`valid` (B, N) bool, default all); npoints > N appends
    uniform picks; every pick that lands on an invalid row (fewer valid
    rows than picks) is replaced by a uniform pick, with replacement,
    among the valid rows. The draws come from `draws`, {"gumbel": (B, N)
    float, "extra": (B, max(npoints - N, 0)) and "repl": (B, npoints)
    integers in [0, N)} (the JAX package's, for parity), else from
    `generator` on pc's device."""
    b, n, _ = pc.shape
    dev = pc.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    _check_valid(valid, b, n, dev)
    if draws is None:
        u = torch.rand((b, n), generator=generator, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        draws = {"gumbel": -torch.log(-torch.log(torch.clamp(u, min=tiny))),
                 "extra": torch.randint(0, n, (b, max(npoints - n, 0)), generator=generator,
                                        device=dev),
                 "repl": torch.randint(0, n, (b, npoints), generator=generator, device=dev)}
    g = draws["gumbel"].to(dev, torch.float32) + torch.where(valid, 0.0, -1e9)
    idx = torch.topk(g, min(npoints, n), dim=-1, largest=True, sorted=True).indices
    if npoints > n:
        idx = torch.cat([idx, draws["extra"].to(dev, torch.int64)], dim=-1)
    picked_valid = torch.gather(valid, 1, idx)
    count = torch.clamp(valid.sum(dim=-1, keepdim=True), min=1)
    # replacement picks: uniform over the valid rows, valid rows first
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    repl = torch.gather(order, 1, draws["repl"].to(dev, torch.int64) % count)
    idx = torch.where(picked_valid, idx, repl)
    return gather_points(pc, idx), idx
