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
  `k4_weight_pack`).

Weights are `((w1, b1), (w2, b2), (w3, b3))` with w_i of shape
(C_{i-1}, C_i), the Flax kernel layout. A CPU tensor runs the plain
version (`*_reference`), a CUDA tensor launches the kernel or raises.
Each wrapper counts its kernel launches in its `launches` attribute.
"""

import torch

from gaddpg_tpu_torch.ops import build


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


def check_tile_widths(name, weights):
    """What the row-tile kernels (K3, K5) need beyond the plain version:
    every layer width a multiple of 8 up to 256 (one tile's accumulators
    on the tensor cores), and weights that cp.async can read as 16-byte
    rows."""
    for w in weights:
        if w.shape[1] % 8 or w.shape[1] > 256 or w.data_ptr() % 16:
            raise ValueError(
                f"{name}: layer width {w.shape[1]} must be a multiple of 8 up to 256 "
                "and its weights 16-byte aligned"
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


def _check_kernel_layout(name, cin, c1, c2, c3):
    """What the K4 kernel takes beyond the plain version: hidden widths
    of 256, an output width that is a multiple of 256, and an input width
    whose tile fits in shared memory (up to K4_MAX_IN). Raises ValueError
    otherwise."""
    if c1 != K4_HIDDEN or c2 != K4_HIDDEN or c3 % K4_PASS or not 1 <= cin <= K4_MAX_IN:
        raise ValueError(
            f"{name}: the kernel takes widths C_in <= {K4_MAX_IN} -> {K4_HIDDEN} -> "
            f"{K4_HIDDEN} -> a multiple of {K4_PASS}; got {cin} -> {c1} -> {c2} -> {c3}"
        )
    stride = _pad8(max(cin, K4_HIDDEN)) + 4
    smem = 4 * (K4_STAGES * 2 * K4_PASS * 8 + K4_BLOCK_ROWS * stride) + 16 * K4_STAGES
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {smem} bytes of shared memory, more than "
                         f"{build.MAX_SMEM_BYTES}")


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


def k4_weight_pack(weights):
    """The weight stream of the K4 kernel, (steps, 2, 2048) float32: for
    each layer, each 256-column pass and each k8 step of the input width
    (padded to a multiple of 8 with zero rows), the TF32 hi part and then
    the lo part (`tf32_split`) of the (256 columns x 8 inputs) block of w,
    in the order the kernel consumes them. A block is laid out K-major in
    wgmma's core matrices: the step's two halves of 4 inputs, each (256,
    4) row-major, i.e. block[h, c, q] = w[8 step + 4 h + q, 256 pass + c].
    Raises ValueError on widths the kernel does not take
    (`_check_kernel_layout`)."""
    widths = [w.shape for w, _ in weights]
    _check_kernel_layout("mlp_maxpool", widths[0][0], *(c for _, c in widths))
    steps = []
    for w, _ in weights:
        cin, cout = w.shape
        kpad = _pad8(cin)
        wp = torch.nn.functional.pad(w, (0, 0, 0, kpad - cin))
        # (step, half, q, pass, c) -> (pass, step, half, c, q)
        steps.append(wp.reshape(kpad // 8, 2, 4, cout // K4_PASS, K4_PASS)
                     .permute(3, 0, 1, 4, 2).reshape(-1, 8 * K4_PASS))
    hi, lo = tf32_split(torch.cat(steps))
    return torch.stack((hi, lo), dim=1)


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

    CPU tensor: `mlp_maxpool_reference`. CUDA tensor: the K4 kernel on
    the weights split and laid out by `k4_weight_pack` (widths as
    `_check_kernel_layout` states)."""
    if full.dtype != torch.float32 or full.dim() != 3:
        raise ValueError(f"mlp_maxpool: full {full.dtype} {tuple(full.shape)}")
    b, n, cin = full.shape
    c1, c2, c3 = _check_widths("mlp_maxpool", weights, cin)
    dev = build.kernel_device("mlp_maxpool", full,
                              *(t for layer in weights for t in layer))
    if dev.type == "cpu":
        return mlp_maxpool_reference(full, weights)
    wpack = k4_weight_pack(weights)
    out = torch.zeros((b, 1, c3), dtype=torch.float32, device=dev)
    build.launch(
        "mlp_maxpool", dev, full.data_ptr(), wpack.data_ptr(),
        *(bias.data_ptr() for _, bias in weights), out.data_ptr(), b, n, cin, c3,
    )
    mlp_maxpool.launches += 1
    return out


mlp_maxpool.launches = 0

