"""Train-mode set abstraction: batch-statistics BatchNorm and the K5/K6
kernels (counterpart of gaddpg_tpu/ops/pallas_sa_train.py).

In train mode each BatchNorm normalises with the batch's own statistics,
which exist only after the layer's output over the whole batch does, so
the eval kernels' weight folding cannot run up front. Per layer i:

    z_i     = h_{i-1} @ w_i + b_i          (h_0: the centred group rows)
    stats_i = per-channel mean and E[z^2] - mean^2 of z_i over every row
    h_i     = relu(z_i * a_i + c_i)         (`bn_affine` of stats_i)
    pooled  = max of h_3 over each group

with var = E[z^2] - mean^2 unclamped, as the JAX kernels compute it.

- `sa_train_fused` (grouped level; K5, `csrc/sa_train_stats.cu` on the
  row-tile engine of `csrc/sa_tile.cuh`): one pass per layer over each
  group's distinct slots (`ops.sa.distinct_slots`), each pass writing
  z_i to a scratch tensor that the next pass reads, the statistics
  weighted by the slots each row stands for, then a pooling pass. The
  JAX kernel recomputes layers 1..i-1 in pass i and all three in a final
  forward; this one computes each layer once.
- `groupall_train_fused` (group-all level; K6, `csrc/groupall_layer.cu`
  on wgmma): one launch per layer over all B * N rows as a row-tiled
  GEMM, each writing z_i to scratch and its tiles' partial sums, a
  reduction of those into the statistics, the next layer reading z_i
  through its affine and ReLU, then a pooling pass. The JAX kernel
  recomputes layers 1..i-1 in stats pass i and all three in a final
  forward; this one computes each layer once, with no final forward.

Under a data-parallel mesh (`parallel.mesh`; `mesh=` of both wrappers)
each rank holds its share of the batch and every statistic is over the
global batch, as the JAX package's sharded program computes it: each
layer's launch leaves its per-rank sums of z and z^2 (weighted as above)
with their row count, the sums are added across the ranks, and
`ops.sa.bn_from_sums` turns them into the global mean, variance and
affine that the next layer's launch reads z through. The plain versions
take the same reduction through the differentiable `all_reduce_sum`, so
the backward's recompute differentiates through the global statistics.
Without a mesh nothing of this runs.

Each is a `torch.autograd.Function`. Its backward is the JAX package's
rule: it keeps only the inputs and differentiates the plain version
(`sa_train_reference` / `groupall_train_reference`) recomputed under
autograd. Each returns pooled plus ((mean, var),) * 3, the statistics
detached. A CPU tensor runs the plain version forward, a CUDA tensor the
kernels or raises. `launches` counts the calls that launched the
kernels.

Dense layers are ((w, b, scale, bias),) * 3 with w of shape (C_in, C_out),
the Flax kernel layout, and scale / bias the BatchNorm's parameters.
"""

import torch

from gaddpg_tpu_torch.ops import build
from gaddpg_tpu_torch.ops.sa import (
    _check_widths, bn_from_sums, check_tile_widths, groupall_engine, row_list_ints,
)
from gaddpg_tpu_torch.parallel.mesh import all_reduce_sum, sum_over_ranks

BN_EPS = 1e-5
ROW_TILE = 64  # rows of K5's tiles (csrc/sa_tile.cuh kRowTile): one partial sum each


def bn_affine(mean, var, scale, bias, eps: float = BN_EPS):
    """(mean, var, scale, bias) -> (a, c) with bn(z) = z * a + c."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def batch_moments(z, dims, mesh=None, sum_dtype=None):
    """(mean, E[z^2] - mean^2) of z over `dims`, which leave one axis (the
    channels: the last of a (rows, C) tensor, axis 1 of an NCHW image),
    accumulated in `sum_dtype` (default z's) and returned in z's dtype;
    with a data-parallel `mesh`, over every rank's rows: the sums and the
    row count are added across the ranks (differentiably) before the
    division."""
    if mesh is None:
        if sum_dtype is None:
            m = z.mean(dim=dims)
            return m, (z * z).mean(dim=dims) - m * m
        m = z.mean(dim=dims, dtype=sum_dtype)
        v = (z * z).mean(dim=dims, dtype=sum_dtype) - m * m
        return m.to(z.dtype), v.to(z.dtype)
    count = 1
    for d in dims:
        count *= z.shape[d]
    s1 = z.sum(dim=dims, dtype=sum_dtype)
    c = s1.shape[0]
    local = torch.cat([s1, (z * z).sum(dim=dims, dtype=sum_dtype),
                       s1.new_full((1,), float(count))])
    total = all_reduce_sum(mesh, local)
    n = total[2 * c]
    m = total[:c] / n
    return m.to(z.dtype), (total[c:2 * c] / n - m * m).to(z.dtype)


def _train_mlp(h, dense, dims, mesh=None):
    """3x (Dense -> BatchNorm with the statistics of its output over
    `dims`, and over every rank's rows with a `mesh` -> ReLU) ->
    (h, ((mean, var),) * 3)."""
    stats = []
    for w, b, scale, bias in dense:
        z = h @ w + b
        m, v = batch_moments(z, dims, mesh)
        a, c = bn_affine(m, v, scale, bias)
        h = torch.relu(z * a + c)
        stats.append((m, v))
    return h, tuple(stats)


def sa_train_reference(group_idx, full, cpad, dense, mesh=None):
    """Plain train SA level: group_idx (B, S, K) int, full (B, N, C_in),
    cpad (B, S, C_in) centre offsets (xyz in cols 0:3, zero elsewhere) ->
    pooled (B, S, C3), ((mean, var),) * 3 over B*S*K rows (of every rank
    with a data-parallel `mesh`).

    Computes layer by layer over every slot; the function is the same as
    the JAX package's `_xla_full`."""
    b, s, k = group_idx.shape
    rows = torch.gather(
        full, 1, group_idx.reshape(b, s * k, 1).long().expand(-1, -1, full.shape[-1])
    ).reshape(b, s, k, -1)
    h, stats = _train_mlp(rows - cpad[:, :, None, :], dense, (0, 1, 2), mesh)
    return h.amax(dim=2), stats


def groupall_train_reference(full, dense, mesh=None):
    """Plain train group-all level: full (B, N, C_in), not centred ->
    pooled (B, 1, C3), ((mean, var),) * 3 over B*N rows (of every rank
    with a data-parallel `mesh`; the JAX package's `_xla_groupall_full`)."""
    h, stats = _train_mlp(full, dense, (0, 1), mesh)
    return h.amax(dim=1, keepdim=True), stats


def _dense(params):
    """12 flat tensors -> ((w, b, scale, bias),) * 3."""
    return tuple(tuple(params[4 * i: 4 * i + 4]) for i in range(3))


def _check_dense(name, dense, cin):
    if len(dense) != 3 or any(len(layer) != 4 for layer in dense):
        raise ValueError(f"{name}: expected 3 (w, b, scale, bias) layers")
    widths = _check_widths(name, [(w, b) for w, b, _, _ in dense], cin)
    for (_, _, scale, bias), c in zip(dense, widths):
        if (scale.dtype != torch.float32 or bias.dtype != torch.float32
                or scale.shape != (c,) or bias.shape != (c,)):
            raise ValueError(f"{name}: BatchNorm scale/bias must be float32 of shape ({c},)")


def _sa_train_kernels(group_idx, full, cpad, dense, mesh=None):
    """K5: the compacted row list (laid out by the layer-1 pass), one
    pass per layer and the pooling pass. Scratch is sized for every slot,
    so nothing waits on the device for the count of distinct rows. With
    a data-parallel `mesh`, each pass leaves its sums, which are added
    across the ranks and finished by `bn_from_sums` before the next pass."""
    b, s, k = group_idx.shape
    n, cin = full.shape[1:]
    check_tile_widths("sa_train_fused", [w for w, _, _, _ in dense])
    dev = full.device
    slots = b * s * k
    widths = [cin] + [w.shape[1] for w, _, _, _ in dense]
    rows = torch.empty(row_list_ints(b * s, k), dtype=torch.int32, device=dev)
    # z_1 and z_3 share one buffer, z_2 the other: pass i reads z_{i-1}
    zbuf = (torch.empty(slots * max(widths[1], widths[3]), dtype=torch.float32, device=dev),
            torch.empty(slots * widths[2], dtype=torch.float32, device=dev))
    tiles = -(-slots // ROW_TILE)
    stats, zin, a, c = [], None, None, None
    for layer, (w, w_bias, scale, bias) in enumerate(dense, 1):
        cout = widths[layer]
        zout = zbuf[(layer - 1) % 2]
        partial = torch.empty((tiles, 2, cout), dtype=torch.float32, device=dev)
        mean, var, a_next, c_next = (torch.empty(cout, dtype=torch.float32, device=dev)
                                     for _ in range(4))
        sums = (None if mesh is None
                else torch.empty(2 * cout + 1, dtype=torch.float64, device=dev))
        build.launch("sa_train_layer", dev, group_idx.data_ptr(), full.data_ptr(),
                     cpad.data_ptr(), *(0 if t is None else t.data_ptr() for t in (zin, a, c)),
                     w.data_ptr(), w_bias.data_ptr(), zout.data_ptr(), partial.data_ptr(),
                     rows.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), a_next.data_ptr(), c_next.data_ptr(),
                     0 if sums is None else sums.data_ptr(), b, s, k, n,
                     widths[layer - 1], cout, layer)
        if sums is not None:
            bn_from_sums(sum_over_ranks(mesh, sums), (scale, bias), mean, var, a_next, c_next)
        a, c = a_next, c_next  # bn_affine of (mean, var), from the reduction
        stats.append((mean, var))
        zin = zout
    pooled = torch.zeros((b, s, widths[3]), dtype=torch.float32, device=dev)
    build.launch("sa_train_pool", dev, rows.data_ptr(), zin.data_ptr(), a.data_ptr(),
                 c.data_ptr(), pooled.data_ptr(), b, s, k, widths[3])
    sa_train_fused.launches += 1
    return pooled, tuple(stats)


def _groupall_train_kernels(full, dense, mesh=None):
    """K6: one layer-engine launch per layer over the B * N rows, each
    with its statistics and their BatchNorm affine (the reduction's, over
    every rank's rows with a `mesh`), the next reading z back through
    that affine; then the pooling pass."""
    pooled, stats = groupall_engine(full, [(w, b) for w, b, _, _ in dense],
                                    [(scale, bias) for _, _, scale, bias in dense], mesh)
    groupall_train_fused.launches += 1
    return pooled, stats


# profiler range around every backward recompute, so that a trace can
# tell the plain backward's device time from the rest
BACKWARD_RANGE = "sa_train.backward_recompute"


def _grads(fn, inputs, needs, grad_out):
    """Gradients of fn(*inputs) against grad_out for the inputs whose
    flag in `needs` is set (None for the others), by recomputing fn under
    autograd."""
    with torch.enable_grad(), torch.profiler.record_function(BACKWARD_RANGE):
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        out = fn(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return [next(grads) if need else None for need in needs]


class _SATrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, group_idx, full, cpad, *params):
        dense = _dense(params)
        if full.device.type == "cpu":
            pooled, stats = sa_train_reference(group_idx, full, cpad, dense, mesh)
        else:
            pooled, stats = _sa_train_kernels(group_idx, full, cpad, dense, mesh)
        ctx.mesh = mesh
        ctx.save_for_backward(group_idx, full, cpad, *params)
        flat = [t for mv in stats for t in mv]
        ctx.mark_non_differentiable(*flat)
        return (pooled, *flat)

    @staticmethod
    def backward(ctx, grad_pooled, *_):
        group_idx, *inputs = ctx.saved_tensors

        def pooled(full, cpad, *params):
            return sa_train_reference(group_idx, full, cpad, _dense(params), ctx.mesh)[0]

        return (None, None, *_grads(pooled, inputs, ctx.needs_input_grad[2:], grad_pooled))


class _GroupAllTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, full, *params):
        dense = _dense(params)
        if full.device.type == "cpu":
            pooled, stats = groupall_train_reference(full, dense, mesh)
        else:
            pooled, stats = _groupall_train_kernels(full, dense, mesh)
        ctx.mesh = mesh
        ctx.save_for_backward(full, *params)
        flat = [t for mv in stats for t in mv]
        ctx.mark_non_differentiable(*flat)
        return (pooled, *flat)

    @staticmethod
    def backward(ctx, grad_pooled, *_):
        def pooled(full, *params):
            return groupall_train_reference(full, _dense(params), ctx.mesh)[0]

        return (None, *_grads(pooled, ctx.saved_tensors, ctx.needs_input_grad[1:],
                              grad_pooled))


def _unflatten(out):
    pooled, *flat = out
    return pooled, tuple((flat[2 * i], flat[2 * i + 1]) for i in range(3))


def sa_train_fused(group_idx, full, cpad, dense, mesh=None):
    """Train SA level with batch-statistics BatchNorm: group_idx (B, S, K)
    int32 (indices in [0, N)), full (B, N, C_in), cpad (B, S, C_in), dense
    ((w, b, scale, bias),) * 3 -> pooled (B, S, C3), ((mean, var),) * 3.

    Differentiable in full, cpad and the 12 parameters (the backward
    recomputes `sa_train_reference`). CPU tensors: the plain version.
    CUDA tensors: the K5 kernels, each layer once over each group's
    distinct slots. With a data-parallel `mesh` (`parallel.mesh`) the
    statistics are over every rank's rows, in the forward and in the
    backward's recompute."""
    b, s, _ = group_idx.shape
    cin = full.shape[-1]
    if (group_idx.dtype != torch.int32 or full.dtype != torch.float32
            or cpad.dtype != torch.float32 or full.dim() != 3 or full.shape[0] != b
            or cpad.shape != (b, s, cin)):
        raise ValueError(
            f"sa_train_fused: group_idx {group_idx.dtype} {tuple(group_idx.shape)}, "
            f"full {full.dtype} {tuple(full.shape)}, cpad {cpad.dtype} {tuple(cpad.shape)}"
        )
    _check_dense("sa_train_fused", dense, cin)
    flat = [t for layer in dense for t in layer]
    build.kernel_device("sa_train_fused", group_idx, full, cpad, *flat)
    return _unflatten(_SATrain.apply(mesh, group_idx, full, cpad, *flat))


sa_train_fused.launches = 0


def groupall_train_fused(full, dense, mesh=None):
    """Train group-all SA level: full (B, N, C_in) float32, not centred,
    dense ((w, b, scale, bias),) * 3 -> pooled (B, 1, C3),
    ((mean, var),) * 3.

    Differentiable in full and the 12 parameters. CPU tensors: the plain
    version. CUDA tensors: the K6 layer engine, any widths. With a
    data-parallel `mesh`, statistics over every rank's rows, as in
    `sa_train_fused`."""
    if full.dtype != torch.float32 or full.dim() != 3:
        raise ValueError(f"groupall_train_fused: full {full.dtype} {tuple(full.shape)}")
    _check_dense("groupall_train_fused", dense, full.shape[-1])
    flat = [t for layer in dense for t in layer]
    build.kernel_device("groupall_train_fused", full, *flat)
    return _unflatten(_GroupAllTrain.apply(mesh, full, *flat))


groupall_train_fused.launches = 0
