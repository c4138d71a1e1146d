"""Eval-mode set abstraction: BatchNorm folding and the fused SA kernels.

Counterpart of `gaddpg_tpu/ops/pallas_sa.py`. In eval mode BatchNorm uses
its running statistics, so it folds into the preceding Dense, and one SA
level becomes gather -> 3x (Dense + ReLU) -> max-pool:

- `sa_gather_mlp` (K3, `csrc/sa_gather_mlp.cu`): a grouped level; the
  JAX function handles one cloud and is vmapped, here the batch is the
  leading axis. The kernel computes only each group's distinct slots
  (`distinct_slots`), which give the same pooled max.
- `mlp_maxpool` (K4, `csrc/mlp_maxpool.cu`): the group-all level, on
  wgmma in 3xTF32 with the weights split once per call (`tf32_split`,
  `k4_weight_pack`); widths its fused tile cannot hold (`k4_fused_takes`)
  run on K6's layer engine (`groupall_engine`, `csrc/groupall_layer.cu`),
  one launch per layer.

Weights are `((w1, b1), (w2, b2), (w3, b3))` with w_i of shape
(C_{i-1}, C_i), the Flax kernel layout. A CPU tensor runs the plain
version (`*_reference`), a CUDA tensor launches the kernel or raises.
Each wrapper counts its kernel launches in its `launches` attribute.
"""

import torch

from gaddpg_tpu_torch.ops import build
from gaddpg_tpu_torch.parallel.mesh import sum_over_ranks


def fold_bn(kernel, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the preceding Dense.

    y = ((x @ W + b) - mean) / sqrt(var + eps) * scale + bn_bias
      =  x @ (W * s) + ((b - mean) * s + bn_bias),  s = scale / sqrt(var+eps)

    `kernel` is (in, out), as in Flax."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


def folded_sa_weights(dense, norms):
    """BN-folded ((w, b),) * len(dense), w contiguous (in, out), for an SA
    level's nn.Linear layers `dense` and nn.BatchNorm1d layers `norms`
    (running statistics)."""
    out = []
    for d, bn in zip(dense, norms):
        w, b = fold_bn(d.weight.t(), d.bias, bn.weight, bn.bias,
                       bn.running_mean, bn.running_var, bn.eps)
        out.append((w.contiguous(), b))
    return tuple(out)


def _mlp_relu(h, weights):
    for w, b in weights:
        h = torch.relu(h @ w + b)
    return h


def sa_gather_mlp_reference(group_idx, full, center_pad, weights):
    """Plain PyTorch K3: group_idx (B, S, K) int32, full (B, N, C_in),
    center_pad (B, S, C_in) -> pooled (B, S, C3)."""
    b, s, k = group_idx.shape
    rows = torch.gather(
        full, 1, group_idx.reshape(b, s * k, 1).long().expand(-1, -1, full.shape[-1])
    ).reshape(b, s, k, -1)
    return _mlp_relu(rows - center_pad[:, :, None, :], weights).amax(dim=2)


def distinct_slots(group_idx):
    """(mask, multiplicity), both (..., K), of the slots of each group
    that a grouped SA level must compute: slot 0, standing for every slot
    whose index equals its own (itself included), and each slot k >= 1
    whose index differs from slot 0's, standing for itself; the other
    slots are masked out with multiplicity 0.

    A slot whose index equals slot 0's gathers the same row, so it gives
    slot 0's layer outputs bit for bit: it adds nothing to the pooled max
    and adds slot 0's z once more to the batch sums. So the max over the
    kept rows is the max over all slots, and the multiplicity-weighted
    sums over the kept rows are the sums over all slots. The rule holds
    for any index: out-of-range indices read the zero row in the kernels
    wherever they stand, and repeats that differ from slot 0 are simply
    kept twice. Ball query pads each group with its first hit, so most
    slots of a sparse group repeat slot 0."""
    same = group_idx == group_idx[..., :1]
    mask = ~same
    mask[..., 0] = True
    mult = mask.to(torch.int32)
    mult[..., 0] = same.sum(dim=-1)
    return mask, mult


def row_list_ints(groups, k):
    """int32 scratch of the compacted row list the K3/K5 kernels lay out
    for `groups` groups of `k` slots (csrc/sa_tile.cuh `RowList`): the
    count and prefix sum of each group's distinct slots, and group,
    member and multiplicity of up to every slot."""
    return 2 * groups + 1 + 3 * groups * k


def mlp_maxpool_reference(full, weights):
    """Plain PyTorch K4: full (B, N, C_in) -> (B, 1, C3)."""
    return _mlp_relu(full, weights).amax(dim=1, keepdim=True)


def _check_widths(name, weights, cin):
    if len(weights) != 3:
        raise ValueError(f"{name}: expected 3 (w, b) layers, got {len(weights)}")
    widths = [cin]
    for w, b in weights:
        if (w.dtype != torch.float32 or b.dtype != torch.float32 or w.dim() != 2
                or w.shape[0] != widths[-1] or b.shape != (w.shape[1],)):
            raise ValueError(
                f"{name}: layer ({tuple(w.shape)}, {tuple(b.shape)}) does not "
                f"follow width {widths[-1]} or is not float32"
            )
        widths.append(w.shape[1])
    return widths[1:]


TILE_WIDTH = 256  # output columns of a row tile's accumulators (csrc/sa_tile.cuh kMaxWidth)


def check_tile_widths(name, weights):
    """What the row-tile kernels (K3, K5) need beyond the plain version:
    every layer width a multiple of 8, the hidden widths (the inputs of
    layers 2 and 3) up to TILE_WIDTH, one tile's accumulators on the
    tensor cores, while the last layer may be wider (column passes of
    TILE_WIDTH over the same tile); and weights that cp.async can read as
    16-byte rows."""
    for i, w in enumerate(weights):
        hidden = i < len(weights) - 1
        if w.shape[1] % 8 or (hidden and w.shape[1] > TILE_WIDTH) or w.data_ptr() % 16:
            raise ValueError(
                f"{name}: layer width {w.shape[1]} must be a multiple of 8, a hidden "
                f"width at most {TILE_WIDTH}, and its weights 16-byte aligned"
            )


# K4's tiles (csrc/mlp_maxpool.cu): 64 rows per consumer warpgroup, two
# warpgroups per block, the weights streamed as k8 steps of 256-column
# passes (a TF32 hi and lo part each) through K4_STAGES shared-memory stages
K4_PASS = 256
K4_HIDDEN = 256
K4_MAX_IN = 288
K4_STAGES = 5
K4_BLOCK_ROWS = 128


def _pad8(c):
    return (c + 7) // 8 * 8


def k4_fused_takes(cin, c1, c2, c3):
    """The width test of `mlp_maxpool` on the card: whether the fused K4
    kernel's tile holds these widths, i.e. hidden widths of 256, an output
    width that is a multiple of 256, and an input width whose tile fits in
    shared memory (up to K4_MAX_IN). SA3 at scale 1 passes; any other
    widths run on the layer engine, which takes any width but pays each
    layer's output through device memory (chip_smoke.py times both on
    SA3 at scale 1)."""
    if c1 != K4_HIDDEN or c2 != K4_HIDDEN or c3 % K4_PASS or not 1 <= cin <= K4_MAX_IN:
        return False
    stride = _pad8(max(cin, K4_HIDDEN)) + 4
    smem = 4 * (K4_STAGES * 2 * K4_PASS * 8 + K4_BLOCK_ROWS * stride) + 16 * K4_STAGES
    return smem <= build.MAX_SMEM_BYTES


def _check_kernel_layout(name, cin, c1, c2, c3):
    """Raises ValueError for widths the fused K4 kernel does not take
    (`k4_fused_takes`)."""
    if not k4_fused_takes(cin, c1, c2, c3):
        raise ValueError(
            f"{name}: the fused kernel takes widths C_in <= {K4_MAX_IN} -> {K4_HIDDEN} -> "
            f"{K4_HIDDEN} -> a multiple of {K4_PASS}; got {cin} -> {c1} -> {c2} -> {c3}"
        )


def tf32_split(x):
    """(hi, lo) float32 tensors of TF32 values (low 13 mantissa bits
    zero), each rounded to nearest, ties away from zero, as the card's
    cvt.rna.tf32.f32 does, with hi + lo within 2^-22 |x| of x for
    2^-115 <= |x| < 2^128 (1 - 2^-12), and within 2^-137 (half a TF32
    step at the denormal scale) below. Zeros split into (x, 0) with x's
    sign; +-inf and nan into (x, 0)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    finite = torch.isfinite(x)
    hi = torch.where(finite, rna(x), x)
    lo = torch.where(finite, rna(x - hi), torch.zeros_like(x))
    return hi, lo


def layer_weight_pack_reference(w):
    """The weight stream of one layer w (C_in, C_out) for the wgmma
    kernels, (steps, 2, 2048) float32: for each 256-column pass (C_out
    padded to a multiple of 256 with zero columns) and each k8 step of the
    input width (padded to a multiple of 8 with zero rows), the TF32 hi
    part and then the lo part (`tf32_split`) of the (256 columns x 8
    inputs) block of w, in the order the kernels consume them. A block is
    laid out K-major in wgmma's core matrices: the step's two halves of 4
    inputs, each (256, 4) row-major, i.e. block[h, c, q] = w[8 step + 4 h
    + q, 256 pass + c]."""
    cin, cout = w.shape
    kpad, cpad = _pad8(cin), -(-cout // K4_PASS) * K4_PASS
    wp = torch.nn.functional.pad(w, (0, cpad - cout, 0, kpad - cin))
    # (step, half, q, pass, c) -> (pass, step, half, c, q)
    steps = (wp.reshape(kpad // 8, 2, 4, cpad // K4_PASS, K4_PASS)
             .permute(3, 0, 1, 4, 2).reshape(-1, 8 * K4_PASS))
    hi, lo = tf32_split(steps)
    return torch.stack((hi, lo), dim=1)


def _pack_steps(cin, cout):
    return -(-cout // K4_PASS) * (_pad8(cin) // 8)


def layer_weight_pack(w, out=None):
    """`layer_weight_pack_reference` of w: on a CPU tensor that function,
    on a CUDA tensor the pack kernel (csrc/groupall_layer.cu), written
    into `out` when given (a contiguous (steps, 2, 2048) float32 slice)."""
    if w.device.type == "cpu":
        return layer_weight_pack_reference(w)
    cin, cout = w.shape
    if out is None:
        out = torch.empty((_pack_steps(cin, cout), 2, 8 * K4_PASS), dtype=torch.float32,
                          device=w.device)
    build.launch("weight_pack", w.device, w.contiguous().data_ptr(), cin, cout, out.data_ptr())
    return out


def k4_weight_pack(weights):
    """The weight stream of the fused K4 kernel: the three layers'
    `layer_weight_pack` streams in order. Raises ValueError on widths the
    fused kernel does not take (`k4_fused_takes`)."""
    widths = [w.shape for w, _ in weights]
    _check_kernel_layout("mlp_maxpool", widths[0][0], *(c for _, c in widths))
    if weights[0][0].device.type == "cpu":
        return torch.cat([layer_weight_pack_reference(w) for w, _ in weights])
    steps = [_pack_steps(*w.shape) for w, _ in weights]
    out = torch.empty((sum(steps), 2, 8 * K4_PASS), dtype=torch.float32,
                      device=weights[0][0].device)
    for (w, _), part in zip(weights, out.split(steps)):
        layer_weight_pack(w, part)
    return out


ENGINE_ROWS = 128  # rows of a layer-engine block, one partial sum each (csrc/groupall_layer.cu)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _engine_layer(x, w, bias, z, relu=False, affine=None, bn=None, mesh=None):
    """One layer of the group-all layer engine (csrc/groupall_layer.cu)
    over the rows of x (..., C_in): z (rows, C_out) = h @ w + bias, h = x,
    or with `relu` h = relu(x * a + c) for affine (a, c), relu(x) for
    affine None. With `bn`, the BatchNorm's (scale, bias), returns z's
    (mean, var) over the rows and their BatchNorm affine (a, c)
    (ops/sa_train.py `bn_affine`), else None; with a data-parallel `mesh`
    too, over every rank's rows: the launch leaves its sums, which are
    reduced across the ranks and finished by `bn_from_sums`."""
    cin, cout = w.shape
    rows = x.numel() // cin
    dev = x.device
    pack = layer_weight_pack(w)
    a, c = affine if affine is not None else (None, None)
    partial = mean = var = a_next = c_next = sums = None
    if bn is not None:
        partial = torch.empty((-(-rows // ENGINE_ROWS), 2, cout), dtype=torch.float32, device=dev)
        mean, var, a_next, c_next = (torch.empty(cout, dtype=torch.float32, device=dev)
                                     for _ in range(4))
        if mesh is not None:
            sums = torch.empty(2 * cout + 1, dtype=torch.float64, device=dev)
    build.launch("groupall_layer", dev, x.data_ptr(), _ptr(a), _ptr(c), pack.data_ptr(),
                 bias.data_ptr(), z.data_ptr(), *(_ptr(t) for t in (partial, mean, var)),
                 *(_ptr(t) for t in (bn or (None, None))), _ptr(a_next), _ptr(c_next),
                 _ptr(sums), rows, cin, cout, int(relu))
    if sums is not None:
        bn_from_sums(sum_over_ranks(mesh, sums), bn, mean, var, a_next, c_next)
    return None if bn is None else (mean, var, (a_next, c_next))


def bn_from_sums(sums, bn, mean, var, a, c):
    """mean, var and the BatchNorm affine (a, c) of `bn` = (scale, bias),
    written in place from sums (2 * C + 1 doubles on the card: the sums of
    z and z^2 over every rank's rows, then their count), with the
    arithmetic of the kernels' own reduction (csrc/train_stats.cuh)."""
    scale, bias = bn
    build.launch("bn_from_sums", sums.device, sums.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), mean.data_ptr(), var.data_ptr(), a.data_ptr(), c.data_ptr(),
                 mean.shape[0])


def _engine_pool(z, affine, b, n):
    """(B, 1, C) max over each cloud's n rows of relu(z * a + c) for z
    (B * n, C) and affine (a, c), of relu(z) for affine None
    (csrc/groupall_layer.cu)."""
    cout = z.shape[-1]
    out = torch.empty((b, 1, cout), dtype=torch.float32, device=z.device)
    a, c = affine if affine is not None else (None, None)
    build.launch("groupall_pool", z.device, z.data_ptr(), _ptr(a), _ptr(c),
                 out.data_ptr(), b, n, cout)
    return out


def groupall_engine(full, weights, norms=None, mesh=None):
    """The layer engine over every row of full (B, N, C_in): the layers
    ((w, b),) * 3 one launch each, z_1 and z_3 in one scratch buffer and
    z_2 in another (layer i reads z_{i-1}), then the pool. With `norms`,
    the BatchNorms' ((scale, bias),) * 3, each layer's batch statistics
    and their affine feed the next layer and the pool (K6); without, no
    affine: layers 2 and 3 and the pool take relu(z) (K4's wide widths).
    With a data-parallel `mesh`, the statistics are those of every rank's
    rows (`_engine_layer`). Returns pooled (B, 1, C3) and ((mean, var),) * 3 (empty without
    norms)."""
    b, n, _ = full.shape
    dev = full.device
    widths = [w.shape[1] for w, _ in weights]
    bufs = (torch.empty(b * n * max(widths[0], widths[2]), dtype=torch.float32, device=dev),
            torch.empty(b * n * widths[1], dtype=torch.float32, device=dev))
    x, affine, stats = full, None, []
    for i, (w, bias) in enumerate(weights):
        z = bufs[i % 2][:b * n * w.shape[1]]
        out = _engine_layer(x, w, bias, z, relu=i > 0, affine=affine,
                            bn=None if norms is None else norms[i], mesh=mesh)
        if out is not None:
            mean, var, affine = out
            stats.append((mean, var))
        x = z
    return _engine_pool(x.view(b * n, -1), affine, b, n), tuple(stats)


def sa_gather_mlp(group_idx, full, center_pad, weights):
    """Fused eval SA level: gather K rows of `full` (B, N, C_in) per centre
    by `group_idx` (B, S, K) int32, subtract `center_pad` (B, S, C_in),
    3x (folded Dense + ReLU), max over K -> (B, S, C3) float32.

    Indices must lie in [0, N) (ball query's output does; the kernel
    reads a zero row for any other). CPU tensors:
    `sa_gather_mlp_reference`. CUDA tensors: the K3 kernel, on each
    group's distinct slots."""
    b, s, k = group_idx.shape
    n, cin = full.shape[1], full.shape[2]
    if (group_idx.dtype != torch.int32 or full.dtype != torch.float32
            or center_pad.dtype != torch.float32 or full.shape[0] != b
            or center_pad.shape != (b, s, cin)):
        raise ValueError(
            f"sa_gather_mlp: group_idx {group_idx.dtype} {tuple(group_idx.shape)}, "
            f"full {full.dtype} {tuple(full.shape)}, center_pad "
            f"{center_pad.dtype} {tuple(center_pad.shape)}"
        )
    c1, c2, c3 = _check_widths("sa_gather_mlp", weights, cin)
    dev = build.kernel_device("sa_gather_mlp", group_idx, full, center_pad,
                              *(t for layer in weights for t in layer))
    if dev.type == "cpu":
        return sa_gather_mlp_reference(group_idx, full, center_pad, weights)
    check_tile_widths("sa_gather_mlp", [w for w, _ in weights])
    out = torch.zeros((b, s, c3), dtype=torch.float32, device=dev)
    rows = torch.empty(row_list_ints(b * s, k), dtype=torch.int32, device=dev)
    build.launch(
        "sa_gather_mlp", dev, group_idx.data_ptr(), full.data_ptr(),
        center_pad.data_ptr(), *(t.data_ptr() for layer in weights for t in layer),
        out.data_ptr(), rows.data_ptr(), b, s, k, n, cin, c1, c2, c3,
    )
    sa_gather_mlp.launches += 1
    return out


sa_gather_mlp.launches = 0


def mlp_maxpool(full, weights):
    """Fused eval group-all SA: full (B, N, C_in) float32 -> 3x (folded
    Dense + ReLU) -> max over N -> (B, 1, C3).

    CPU tensor: `mlp_maxpool_reference`. CUDA tensor, by the width test
    `k4_fused_takes` (SA3 at scale 1 passes it): the fused K4 kernel on
    the weights split and laid out by `k4_weight_pack`; at any other widths
    K6's layer engine with no statistics (`groupall_engine`). Both count
    in `launches`."""
    if full.dtype != torch.float32 or full.dim() != 3:
        raise ValueError(f"mlp_maxpool: full {full.dtype} {tuple(full.shape)}")
    b, n, cin = full.shape
    c1, c2, c3 = _check_widths("mlp_maxpool", weights, cin)
    dev = build.kernel_device("mlp_maxpool", full,
                              *(t for layer in weights for t in layer))
    if dev.type == "cpu":
        return mlp_maxpool_reference(full, weights)
    if k4_fused_takes(cin, c1, c2, c3):
        wpack = k4_weight_pack(weights)
        out = torch.zeros((b, 1, c3), dtype=torch.float32, device=dev)
        build.launch(
            "mlp_maxpool", dev, full.data_ptr(), wpack.data_ptr(),
            *(bias.data_ptr() for _, bias in weights), out.data_ptr(), b, n, cin, c3,
        )
    else:
        out = groupall_engine(full, weights)[0]
    mlp_maxpool.launches += 1
    return out


mlp_maxpool.launches = 0

