"""The layouts the wgmma wrappers (ops/sa.py `mlp_maxpool`, K4, and the
layer engine of K6, `groupall_layer`) build for their kernels, checked on
the CPU: the TF32 hi/lo split of the weights (`tf32_split`), the weight
streams (`k4_weight_pack`, `layer_weight_pack`), the widths each kernel
takes (`k4_fused_takes`, `check_tile_widths`). The kernels themselves run
only on the card (chip_smoke.py holds them against `mlp_maxpool_reference`
and `groupall_train_reference`); here float64 walks over the streams in
the kernels' order stand in for them.
"""

import numpy as np
import pytest
import torch

from gaddpg_tpu_torch.ops import sa, sa_train

SA3 = (259, (256, 256, 512))
SA3_SCALE2 = (515, (512, 512, 1024))


def _weights(rng, cin, dims):
    ws, c = [], cin
    for d in dims:
        ws.append((torch.from_numpy((rng.randn(c, d) * 0.3).astype(np.float32)),
                   torch.from_numpy((rng.randn(d) * 0.1).astype(np.float32))))
        c = d
    return tuple(ws)


def _low_bits(t):
    return t.view(torch.int32) & 0x1FFF


def test_tf32_split_reconstructs_fp32():
    """hi and lo are TF32 (low 13 mantissa bits zero), hi is x rounded to
    nearest, and hi + lo is x within 2^-22 relative, over x from 2^-115
    (below it lo is denormal, and its step of 2^-136 bounds the error)
    to 2^121."""
    rng = np.random.RandomState(0)
    mant = rng.uniform(1.0, 2.0, 20000)
    expo = rng.randint(-115, 121, 20000)
    sign = rng.choice([-1.0, 1.0], 20000)
    x = torch.from_numpy((sign * mant * 2.0 ** expo).astype(np.float32))
    hi, lo = sa.tf32_split(x)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    xd, hid = x.double(), hi.double()
    # hi is within half a TF32 step (2^-11 relative to the binade) of x
    assert ((xd - hid).abs() <= 2.0 ** -11 * 2.0 ** torch.floor(torch.log2(xd.abs()))).all()
    err = (hid + lo.double() - xd).abs()
    assert (err <= 2.0 ** -22 * xd.abs()).all()


def test_tf32_split_ties_round_away_from_zero():
    """A value halfway between two TF32 values rounds away from zero, as
    cvt.rna.tf32.f32 does on the card."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    hi, lo = sa.tf32_split(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2 * 2.0 ** -10]
    assert (hi + lo == x).all()


def test_tf32_split_zero_denormal_inf_nan():
    """Zeros split into (x, 0) keeping the sign; a denormal into hi + lo
    within 2^-137 of x; +-inf and nan into (x, 0)."""
    zeros = torch.tensor([0.0, -0.0])
    hi, lo = sa.tf32_split(zeros)
    assert torch.equal(hi.view(torch.int32), zeros.view(torch.int32))
    assert (lo == 0).all()
    den = torch.tensor([1e-40, -3e-42, 2.0 ** -140, 1.1754942e-38], dtype=torch.float32)
    assert (den.abs() < 2.0 ** -126).all()
    hi, lo = sa.tf32_split(den)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    assert ((hi.double() + lo.double() - den.double()).abs() <= 2.0 ** -137).all()
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = sa.tf32_split(special)
    assert hi[0] == float("inf") and hi[1] == float("-inf") and torch.isnan(hi[2])
    assert (lo == 0).all()


def test_k4_weight_pack_layout_at_sa3_widths():
    """Every element of the stream sits where the kernel reads it: stage
    (layer, pass, step), part hi/lo, then [half][column][input % 4]; the
    rows past C_in = 259 (padding to 264) are zero."""
    rng = np.random.RandomState(1)
    cin, dims = SA3
    weights = _weights(rng, cin, dims)
    pack = sa.k4_weight_pack(weights)
    steps = [264 // 8, 256 // 8, 2 * 256 // 8]  # layer 3: two passes of 32 steps
    assert pack.shape == (sum(steps), 2, 2048) and pack.dtype == torch.float32
    assert pack.is_contiguous()
    stage = 0
    for (w, _), n_steps in zip(weights, steps):
        kin, cout = w.shape
        wp = torch.zeros(-(-kin // 8) * 8, cout)
        wp[:kin] = w
        hi, lo = sa.tf32_split(wp)
        per_pass = wp.shape[0] // 8
        assert n_steps == per_pass * cout // 256
        for p in range(cout // 256):
            for step in range(per_pass):
                got = pack[stage].view(2, 2, 256, 4)  # part, half, column, input % 4
                block = lambda t: t[8 * step:8 * step + 8, 256 * p:256 * p + 256]
                want = torch.stack([block(hi), block(lo)]).view(2, 2, 4, 256).transpose(2, 3)
                assert torch.equal(got, want), (stage, p, step)
                stage += 1
    assert stage == pack.shape[0]
    # layer 1's last step holds inputs 256..263: 259 (half 0, q 3) and
    # the whole of half 1 are padding, zero in both parts
    last = pack[steps[0] - 1].view(2, 2, 256, 4)
    assert (last[:, 0, :, 3] == 0).all() and (last[:, 1] == 0).all()
    assert (last[0, 0, :, :3] != 0).any()


def _walk_stream(full, pack, weights):
    """The kernel's arithmetic in float64 on the CPU: every layer from the
    stream in the kernel's order, each product lo(x) hi(w) + hi(x) lo(w)
    + hi(x) hi(w) with x split as the card splits it, then ReLU and the
    max over each cloud's rows."""
    b, n, cin = full.shape
    x = full.reshape(b * n, cin)
    stage = 0
    for layer, (w, bias) in enumerate(weights):
        kin, cout = -(-x.shape[1] // 8) * 8, w.shape[1]
        xp = torch.nn.functional.pad(x, (0, kin - x.shape[1]))
        xh, xl = (t.double() for t in sa.tf32_split(xp))
        z = torch.zeros(b * n, cout, dtype=torch.float64)
        for p in range(cout // 256):
            for step in range(kin // 8):
                blk = pack[stage].double().view(2, 2, 256, 4)
                wh = blk[0].permute(0, 2, 1).reshape(8, 256)
                wl = blk[1].permute(0, 2, 1).reshape(8, 256)
                a_h, a_l = xh[:, 8 * step:8 * step + 8], xl[:, 8 * step:8 * step + 8]
                z[:, 256 * p:256 * p + 256] += a_l @ wh + a_h @ wl + a_h @ wh
                stage += 1
        x = torch.relu(z + bias.double()).float()
    assert stage == pack.shape[0]
    return x.view(b, n, -1).amax(dim=1, keepdim=True)


@pytest.mark.parametrize("b,n", [(3, 32), (1, 32), (2, 7)])
def test_k4_stream_walk_matches_reference(b, n):
    """Walking the stream as the kernel does gives the plain version's
    output within 1e-4 (chip_smoke.py's bound for K4 against it): the
    stream's order is the kernel's order and 3xTF32 keeps fp32 accuracy."""
    rng = np.random.RandomState(2 + b)
    cin, dims = SA3
    weights = _weights(rng, cin, dims)
    full = torch.from_numpy(rng.randn(b, n, cin).astype(np.float32))
    got = _walk_stream(full, sa.k4_weight_pack(weights), weights)
    want = sa.mlp_maxpool_reference(full, weights)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,dims,fused", [
    (1, (256, 256, 512), True),    # SA3's hidden widths, the narrowest input
    (259, (256, 256, 512), True),  # SA3 at scale 1
    (sa.K4_MAX_IN, (256, 256, 512), True),  # the widest input the fused tile holds
    (259, (256, 256, 256), True),
    (11, (16, 16, 24), False),     # tests/test_torch_sa.py's small K4 widths
    (7, (64, 64, 128), False),     # SA1 widths
    (131, (128, 128, 256), False),  # SA2 widths
    (259, (256, 256, 384), False),  # an output that is not a multiple of 256
    (300, (256, 256, 512), False),  # an input tile wider than the fused kernel holds
    (*SA3_SCALE2, False),          # SA3 at scale 2
])
def test_k4_widths_the_kernel_takes(cin, dims, fused):
    """Every width takes a kernel on the card, by the wrapper's width test
    `k4_fused_takes`: the fused kernel (its stream `k4_weight_pack`) for
    SA3's hidden widths, else the layer engine, whose per-layer streams
    (`layer_weight_pack`) take any width, while `k4_weight_pack` raises
    there. On CPU tensors the wrapper runs the plain version."""
    weights = _weights(np.random.RandomState(3), cin, dims)
    assert sa.k4_fused_takes(cin, *dims) == fused
    if fused:
        sa._check_kernel_layout("mlp_maxpool", cin, *dims)
        steps = sum(-(-w.shape[0] // 8) * w.shape[1] // 256 for w, _ in weights)
        assert sa.k4_weight_pack(weights).shape == (steps, 2, 2048)
    else:
        with pytest.raises(ValueError, match="mlp_maxpool"):
            sa.k4_weight_pack(weights)
    for w, _ in weights:  # the engine's streams, at any width
        passes = -(-w.shape[1] // 256)
        assert sa.layer_weight_pack(w).shape == (passes * -(-w.shape[0] // 8), 2, 2048)
    full = torch.zeros(1, 4, cin)
    assert sa.mlp_maxpool(full, weights).shape == (1, 1, dims[-1])


@pytest.mark.parametrize("cin,dims", [(11, (16, 16, 24)), SA3_SCALE2])
def test_layer_weight_pack_layout(cin, dims):
    """Each layer's stream: (pass, step), part hi/lo, [half][column][input
    % 4], with the columns padded to a multiple of 256 and the rows to a
    multiple of 8 with zeros."""
    for w, _ in _weights(np.random.RandomState(4), cin, dims):
        kin, cout = w.shape
        kpad, cpad = -(-kin // 8) * 8, -(-cout // 256) * 256
        wp = torch.zeros(kpad, cpad)
        wp[:kin, :cout] = w
        hi, lo = sa.tf32_split(wp)
        pack = sa.layer_weight_pack(w)
        steps = kpad // 8
        for p in range(cpad // 256):
            for step in range(steps):
                got = pack[p * steps + step].view(2, 2, 256, 4)
                block = lambda t: t[8 * step:8 * step + 8, 256 * p:256 * p + 256]
                want = torch.stack([block(hi), block(lo)]).view(2, 2, 4, 256).transpose(2, 3)
                assert torch.equal(got, want), (p, step)


def _walk_engine(full, layers):
    """The layer engine's arithmetic on the CPU (csrc/groupall_layer.cu):
    each layer's stream (`layer_weight_pack`) walked pass by pass and step
    by step in float64, each product lo(x) hi(w) + hi(x) lo(w) + hi(x)
    hi(w) with x split as the card splits it, z = acc + b in float32, and
    the next layer's input relu(z * a + c) for train layers (w, b, scale,
    bias), with the affine of z's batch statistics (sums in float64, then
    `bn_affine` in float32, as the wrapper computes it), and relu(z) for
    eval layers (w, b). Returns pooled (B, 1, C3) and the statistics."""
    b, n, cin = full.shape
    x, stats = full.reshape(b * n, cin), []
    for w, bias, *bn in layers:
        kin, cout = -(-x.shape[1] // 8) * 8, w.shape[1]
        passes = -(-cout // 256)
        xh, xl = (t.double() for t in sa.tf32_split(
            torch.nn.functional.pad(x, (0, kin - x.shape[1]))))
        pack = sa.layer_weight_pack(w).double()
        z = torch.zeros(b * n, passes * 256, dtype=torch.float64)
        for p in range(passes):
            for step in range(kin // 8):
                blk = pack[p * (kin // 8) + step].view(2, 2, 256, 4)
                wh = blk[0].permute(0, 2, 1).reshape(8, 256)
                wl = blk[1].permute(0, 2, 1).reshape(8, 256)
                a_h, a_l = xh[:, 8 * step:8 * step + 8], xl[:, 8 * step:8 * step + 8]
                z[:, 256 * p:256 * p + 256] += a_l @ wh + a_h @ wl + a_h @ wh
        z = z[:, :cout].float() + bias
        if bn:
            zd = z.double()
            m = zd.mean(dim=0)
            stats.append((m.float(), ((zd * zd).mean(dim=0) - m * m).float()))
            a, c = sa_train.bn_affine(*stats[-1], *bn)
            z = z * a + c
        x = torch.relu(z)
    return x.view(b, n, -1).amax(dim=1, keepdim=True), stats


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cin,dims", [SA3, SA3_SCALE2])
def test_engine_stream_walk_matches_reference(cin, dims, train):
    """Walking each layer's stream as the layer engine does gives the
    plain version's output within 1e-4 (chip_smoke.py's bound): K4's
    wide branch (eval, folded weights) against `mlp_maxpool_reference`,
    K6 (train, batch statistics) against `groupall_train_reference`, its
    statistics too, at both model scales; 3 x 7 rows fill no tile."""
    rng = np.random.RandomState(5 + cin)
    weights = _weights(rng, cin, dims)
    full = torch.from_numpy((rng.randn(3, 7, cin) * 0.5).astype(np.float32))
    if not train:
        got, _ = _walk_engine(full, weights)
        torch.testing.assert_close(got, sa.mlp_maxpool_reference(full, weights),
                                   rtol=1e-4, atol=1e-4)
        return
    dense = tuple((w, b, torch.from_numpy(rng.uniform(0.8, 1.3, w.shape[1]).astype(np.float32)),
                   torch.from_numpy((rng.randn(w.shape[1]) * 0.05).astype(np.float32)))
                  for w, b in weights)
    got, stats = _walk_engine(full, dense)
    want, want_stats = sa_train.groupall_train_reference(full, dense)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for (m, v), (wm, wv) in zip(stats, want_stats, strict=True):
        torch.testing.assert_close(m, wm, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(v, wv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dims,ok", [
    ((64, 64, 128), True),     # SA1, scale 1
    ((128, 128, 256), True),   # SA2, scale 1, and SA1, scale 2
    ((256, 256, 512), True),   # SA2, scale 2: the last layer in two column passes
    ((256, 264, 256), False),  # a hidden width past one tile's accumulators
    ((64, 64, 132), False),    # a width that is not a multiple of 8
])
def test_tile_widths(dims, ok):
    """The row-tile kernels (K3, K5) take hidden widths up to 256 and a
    last layer of any multiple of 8 (`check_tile_widths`)."""
    ws = [w for w, _ in _weights(np.random.RandomState(6), 7, dims)]
    if ok:
        sa.check_tile_widths("sa_gather_mlp", ws)
    else:
        with pytest.raises(ValueError, match="sa_gather_mlp"):
            sa.check_tile_widths("sa_gather_mlp", ws)


# GoalFeature's trunk (models/pointnet.py GoalFeature): clouds of 512
# points, xyz only, so SA1 takes 6 columns (the centred xyz and the xyz)
# at 128 centres of 64 slots; the generator's clouds end in all-zero rows
GOAL_POINTS, GOAL_CENTRES, GOAL_NSAMPLE = 512, 128, 64
GOAL_SA1 = (6, (64, 64, 128))


def _goal_cloud(rng, b, hits):
    """(B, 512, 3) clouds: `hits` points of a 4 cm blob, then zero rows."""
    xyz = np.zeros((b, GOAL_POINTS, 3), np.float32)
    xyz[:, :hits] = rng.randn(b, hits, 3).astype(np.float32) * 0.02
    return torch.from_numpy(xyz)


@pytest.mark.parametrize("b,hits", [(2, 50), (3, 300), (1, 512)])
def test_goal_sa1_compaction_walk(b, hits):
    """K3/K5's compaction at GoalFeature's SA1 on clouds with zero rows:
    FPS runs out of distinct points and repeats its first pick on the
    ties, and the zero rows fill groups with one row under many indices;
    walking only the distinct slots, each
    weighted by its multiplicity (`distinct_slots`), gives the plain train
    level's pooled output and batch statistics (float64 walk against
    `sa_train_reference` within 1e-4), on 6-column rows padded to 8."""
    from gaddpg_tpu_torch.ops import sampling

    rng = np.random.RandomState(b + hits)
    xyz = _goal_cloud(rng, b, hits)
    centers = sampling.fps_reference(xyz, GOAL_CENTRES)
    new_xyz = sampling.gather_points(xyz, centers)
    idx = sampling.ball_query_reference(new_xyz, xyz, 0.02, GOAL_NSAMPLE)
    mask, mult = sa.distinct_slots(idx)
    for i in range(b):
        assert len(torch.unique(centers[i])) <= hits + 1
    if hits < GOAL_CENTRES:
        assert (centers[:, hits + 1:] == centers[:, :1]).all()
    full = torch.cat([xyz, xyz], dim=-1)
    assert full.shape[-1] == GOAL_SA1[0] and sa._pad8(GOAL_SA1[0]) == 8
    cpad = torch.nn.functional.pad(new_xyz, (0, 3))
    dense = tuple((w, bias, torch.ones(w.shape[1]), torch.zeros(w.shape[1]))
                  for w, bias in _weights(rng, *GOAL_SA1))
    sa.check_tile_widths("sa_train", [w for w, *_ in dense])
    want, want_stats = sa_train.sa_train_reference(
        idx, full.double(), cpad.double(), tuple(tuple(t.double() for t in d) for d in dense))
    # the walk: distinct rows only, sums weighted by multiplicity
    rows = torch.gather(full.double(), 1, idx.reshape(b, -1, 1).long().expand(-1, -1, 6))
    x = (rows.reshape(b, GOAL_CENTRES, GOAL_NSAMPLE, 6) - cpad.double()[:, :, None])[mask]
    weight = mult[mask].double()[:, None]
    seg = torch.arange(b * GOAL_CENTRES).reshape(b, GOAL_CENTRES, 1).expand_as(mask)[mask]
    for (w, bias, scale, shift), (wm, wv) in zip(dense, want_stats, strict=True):
        z = x @ w.double() + bias.double()
        m = (weight * z).sum(0) / weight.sum()
        v = (weight * z * z).sum(0) / weight.sum() - m * m
        torch.testing.assert_close(m, wm, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(v, wv, rtol=1e-9, atol=1e-9)
        x = torch.relu((z - m) * (torch.rsqrt(v + 1e-5) * scale.double()) + shift.double())
    pooled = torch.full((b * GOAL_CENTRES, x.shape[1]), -np.inf, dtype=torch.float64)
    pooled = pooled.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax")
    torch.testing.assert_close(pooled.reshape(want.shape), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("b", [1, 32, 64])
def test_goal_feature_launch_layouts(b):
    """The launches GoalFeature's trunk asks for fit the card: K2 at 128
    centres over 512 points (centres a block and shared memory on 132
    SMs), K3/K5's row list for B x 128 groups of 64 slots, the tile
    widths of SA1 (6 -> 64 -> 64 -> 128) and SA2, and SA3 on K4's fused
    kernel at 259 columns, as the policy's."""
    from gaddpg_tpu_torch.ops import build, sampling

    centres, smem = sampling.ball_query_layout(b, GOAL_CENTRES, GOAL_POINTS, GOAL_NSAMPLE, 132)
    assert 1 <= centres <= GOAL_CENTRES and smem <= build.MAX_SMEM_BYTES
    assert sa.row_list_ints(b * GOAL_CENTRES, GOAL_NSAMPLE) == (
        2 * b * GOAL_CENTRES + 1 + 3 * b * GOAL_CENTRES * GOAL_NSAMPLE)
    rng = np.random.RandomState(7)
    for cin, dims in (GOAL_SA1, (131, (128, 128, 256))):
        sa.check_tile_widths("sa_gather_mlp", [w for w, _ in _weights(rng, cin, dims)])
    assert sa.k4_fused_takes(*SA3[:1], *SA3[1])
