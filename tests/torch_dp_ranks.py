"""Rank programs of the data-parallel tests (tests/test_torch_dp_*.py).

`gaddpg_tpu_torch.parallel.launch` runs each in spawned processes, one
per rank on the CPU over gloo, as fn(mesh, *args). They import torch and
the port only (no JAX), take their inputs as numpy arrays made from a
seed in the test process, and return numpy arrays.
"""

import time

import numpy as np
import torch

from gaddpg_tpu_torch.parallel import mesh as mesh_lib


def _np(t):
    return t.detach().cpu().numpy().copy()


def _local(mesh, a):
    """This rank's rows of a numpy array, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(mesh_lib.shard_leading_axis(mesh, a)))


# -- mesh ------------------------------------------------------------------------

def mesh_checks(mesh):
    """make_mesh, the collectives and replicate, on this rank."""
    out = {"world": mesh_lib.make_mesh(mesh.world).world}
    try:
        mesh_lib.make_mesh(mesh.world + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    # all_reduce_sum forward and backward: y = sum_r x_r^2, loss_r = y . w_r
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    y = mesh_lib.all_reduce_sum(mesh, x * x)
    (y * torch.arange(3.0)).sum().backward()
    out["sum"], out["sum_grad"] = _np(y), _np(x.grad)
    # rank r sends r + 1 rows to each rank q, valued 100 r + q
    send = torch.cat([torch.full((mesh.rank + 1, 2), 100.0 * mesh.rank + q)
                      for q in range(mesh.world)])
    out["all_to_all"] = _np(mesh_lib.all_to_all_rows(
        mesh, send, [mesh.rank + 1] * mesh.world, [r + 1 for r in range(mesh.world)]))
    out["gather"] = _np(mesh_lib.all_gather_rows(mesh, torch.tensor([[mesh.rank]])))
    t = [torch.full((2,), float(mesh.rank)), torch.tensor([mesh.rank])]
    mesh_lib.replicate(mesh, t)
    out["replicated"] = [_np(v) for v in t]
    try:
        mesh_lib.replicate(mesh, [torch.full((2,), float(mesh.rank))], check=True)
    except RuntimeError as e:
        out["replicate_check"] = str(e)
    out["draw"] = _np(mesh_lib.draw_rows(
        mesh, lambda s: torch.rand(s, generator=torch.Generator().manual_seed(0)), (2, 3)))
    # bfloat16 moves as its bytes: row q of this rank's rows goes to rank q
    rows = bf16_rows(mesh.rank)
    out["bf16_gather"] = _np(mesh_lib.all_gather_rows(mesh, rows).view(torch.int16))
    out["bf16_all_to_all"] = _np(mesh_lib.all_to_all_rows(
        mesh, rows[:mesh.world], [1] * mesh.world, [1] * mesh.world).view(torch.int16))
    try:
        mesh_lib.sum_over_ranks(mesh, rows)
    except TypeError as e:
        out["bf16_sum"] = str(e)
    return out


def bf16_rows(rank):
    """(4, 3) bfloat16 rows with bit patterns a float round trip could
    change: -0.0, infinities, a subnormal, values of every rank's own."""
    bits = torch.tensor([[-32768, 0x7f80, -128], [0x0001, 0x3f80 + rank, 0x4049],
                         [0x0100 + rank, -16512, 0x7f7f], [rank, 1, 2]], dtype=torch.int16)
    return bits.view(torch.bfloat16)


def raise_on_one(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh_lib.sum_over_ranks(mesh, torch.ones(1))
    time.sleep(600)


# -- train-mode statistics ---------------------------------------------------------

def stats_ranks(mesh, cases):
    """`stats_rank` of each (kind, arrays, reduce) of `cases`, in order."""
    return [stats_rank(mesh, *case) for case in cases]


def stats_rank(mesh, kind, arrays, reduce=True):
    """This rank's rows of `arrays` through the train level `kind` ("sa",
    "groupall" or "bn"), the statistics over every rank's rows (or, with
    reduce=False, this rank's alone: per-rank BatchNorm). Returns the
    output, the statistics and the gradients of sum(output^2) in the
    inputs (this rank's rows) and the parameters (this rank's share)."""
    from gaddpg_tpu_torch.models.pointnet import batch_norm_train
    from gaddpg_tpu_torch.ops.sa_train import groupall_train_fused, sa_train_fused

    m = mesh if reduce else None
    params = [torch.from_numpy(a).requires_grad_() for a in arrays["params"]]
    if kind == "bn":
        bn = torch.nn.BatchNorm1d(params[0].shape[0])
        bn.weight, bn.bias = torch.nn.Parameter(params[0]), torch.nn.Parameter(params[1])
        params = [bn.weight, bn.bias]
        inputs = [_local(mesh, arrays["x"]).requires_grad_()]
        y, mean, var = batch_norm_train(bn, inputs[0], m)
        y = torch.relu(y)  # as the trunk runs it: sum(y^2) of y = BN(x) is constant in x
        stats = [(mean, var)]
    else:
        dense = tuple(tuple(params[4 * i: 4 * i + 4]) for i in range(3))
        inputs = [_local(mesh, arrays["full"]).requires_grad_()]
        if kind == "sa":
            inputs.append(_local(mesh, arrays["cpad"]).requires_grad_())
            y, stats = sa_train_fused(_local(mesh, arrays["group_idx"]), *inputs, dense, m)
        else:
            y, stats = groupall_train_fused(inputs[0], dense, m)
    grads = torch.autograd.grad((y * y).sum(), inputs + params)
    return {"out": _np(y), "stats": [(_np(a), _np(b)) for a, b in stats],
            "grads": [_np(g) for g in grads]}


# -- updates -----------------------------------------------------------------------

def update_rank(mesh, kind, cfg_kw, state_kw, batch, noise):
    """One sharded DDPG or BC update (`make_sharded_update`, the global
    batch in) from a `from_flax` state -> (metrics, every state tensor,
    the Flax-layout leaves of each group, the running statistics, the
    counts)."""
    from gaddpg_tpu_torch.agents import AgentConfig, from_flax, make_bc_update, make_ddpg_update
    from gaddpg_tpu_torch.agents.state import (
        _critic_pairs, _encoder_stat_pairs, _pairs, _policy_pairs, state_counts, state_tensors,
    )

    cfg = AgentConfig(**cfg_kw)
    state = from_flax(cfg=cfg, device="cpu", **state_kw)
    make = make_bc_update if kind == "bc" else make_ddpg_update
    run = mesh_lib.make_sharded_update(make(cfg, "cpu", mesh=mesh), mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = (run(state, tb) if kind == "bc"
               else run(state, tb, noise_draws=torch.from_numpy(noise)))
    pairs = dict(_pairs(state), policy_target=_policy_pairs(state.policy_target),
                 critic_target=_critic_pairs(state.critic_target))
    leaves = {name: [(path, _np(t).T if transpose else _np(t)) for t, path, transpose in p]
              for name, p in pairs.items()}
    stats = {name: [(path, _np(t)) for t, path, _ in _encoder_stat_pairs(getattr(state.feat,
                                                                                name))]
             for name in ("encoder", "value_encoder")}
    return ({k: float(v) for k, v in metrics.items()}, [_np(t) for t in state_tensors(state)],
            leaves, stats, state_counts(state))


# -- replay ring -------------------------------------------------------------------

def ring_rank(mesh, inserts, size, num_points, samples, draw_seed):
    """The ring of `size` on this mesh: each insert (episodes, valid) of
    the global envs, this rank's rows of them going in; then the gathered
    ring, the cursors, this rank's rows of a sample at each given global
    `idx`, and the global idx drawn from a generator seeded `draw_seed`
    (every rank's)."""
    from gaddpg_tpu_torch import replay
    from gaddpg_tpu_torch.replay.buffer import gather_buffer

    buf = replay.create_buffer(size, num_points=num_points, device="cpu", mesh=mesh)
    for episodes, valid in inserts:
        replay.add_episodes(buf, {k: _local(mesh, v) for k, v in episodes.items()},
                            _local(mesh, valid), 0.95)
    rows = [{k: _np(v) for k, v in replay.sample(buf, len(i), episode_max_len=2,
                                                 idx=torch.from_numpy(i)).items()}
            for i in samples]
    gen = torch.Generator().manual_seed(draw_seed)
    drawn = replay.sample(buf, 4 * mesh_lib.world_of(mesh), episode_max_len=2,
                          generator=gen)["batch_idx"]
    return ({k: _np(v) for k, v in gather_buffer(buf).items()},
            (buf.cur_idx, buf.filled, buf.total_env_step), rows,
            _np(mesh_lib.all_gather_rows(mesh, drawn)), buf.point_state.shape[0])


# -- train iteration ---------------------------------------------------------------

def trainer_rank(mesh, sizes, flagship, output_dir, library_path=None):
    """One Trainer iteration of a dry-run tier's configuration at the
    sizes of a `sizes`-rank dry run, on this mesh (one rank: mesh None, in
    the test process): collect, the gathered ring, one update. ->
    (collect stats, ring, update metrics, update_step, every state tensor,
    this rank's slots of the ring)."""
    from gaddpg_tpu_torch.agents.state import state_tensors
    from gaddpg_tpu_torch.parallel.dryrun import tier_config, tier_library
    from gaddpg_tpu_torch.replay.buffer import gather_buffer
    from gaddpg_tpu_torch.train.loop import Trainer

    cfg = tier_config(sizes, output_dir, flagship)
    tr = Trainer(cfg, lib=tier_library(flagship, library_path), mesh=mesh, device="cpu")
    roll = tr.collect()
    ring = {k: _np(v) for k, v in gather_buffer(tr.buffer).items()}
    metrics = tr.train_iter()
    return (roll, ring, metrics, tr.update_step, [_np(t) for t in state_tensors(tr.agent_state)],
            tr.buffer.point_state.shape[0])


def restore_and_evaluate_rank(mesh, sizes, output_dir, snapshot_dir, scenes):
    """A fast-tier Trainer on this mesh (one rank: mesh None): resume from
    `snapshot_dir` (rank 0 reads it and broadcasts), then evaluate one
    wave of fresh scenes with the policy and one of `scenes` with the
    expert. -> (every state tensor, the counts, both success rates)."""
    from gaddpg_tpu_torch.agents.state import state_counts, state_tensors
    from gaddpg_tpu_torch.parallel.dryrun import tier_config, tier_library
    from gaddpg_tpu_torch.train.loop import Trainer

    tr = Trainer(tier_config(sizes, output_dir), lib=tier_library(False), mesh=mesh,
                 device="cpu")
    assert tr.load_pretrained(snapshot_dir)
    policy, _ = tr.evaluate(episodes=1)
    expert, _ = tr.evaluate(episodes=1, scenes=scenes, expert=True)
    return ([_np(t) for t in state_tensors(tr.agent_state)], state_counts(tr.agent_state),
            policy, expert)


# -- image mode --------------------------------------------------------------------

def image_feature_rank(mesh, arrays, reduce=True, world=1):
    """This rank's rows of `arrays["image"]` (and "action") through both
    encoders of an ImageFeature holding the seeded weights of
    `arrays["seed"]` (torch_image_common.random_resnet), train forward,
    the statistics over every rank's rows (or, with reduce=False, this
    rank's alone). Returns each path's output, its statistics, and the
    gradients of sum(output^2) in the image rows and in the parameters
    (this rank's share). With mesh None, `world` rank shares of the
    image run one after another in this process (the one-rank
    reference is world=1)."""
    from gaddpg_tpu_torch.models import ImageFeature
    from torch_image_common import random_resnet

    feat = ImageFeature()
    feat.encoder = random_resnet(arrays["seed"])
    feat.value_encoder = random_resnet(arrays["seed"] + 1)
    m = mesh if reduce else None
    out = {}
    for path, kw in (("policy", {}), ("value", {"value": True})):
        img = _local(mesh, arrays["image"]).requires_grad_()
        if kw:
            kw = {"value": True, "action": _local(mesh, arrays["action"])}
        y, stats = feat(img, train=True, mesh=m, **kw)
        params = [p for p in (feat.value_encoder if kw else feat.encoder).parameters()]
        grads = torch.autograd.grad((y * y).sum(), [img] + params)
        out[path] = {"out": _np(y), "stats": [(_np(a), _np(b)) for a, b in stats],
                     "grads": [_np(g) for g in grads]}
    return out


def image_trainer_rank(mesh, sizes, output_dir):
    """One image-mode Trainer iteration (use_image, domain_rand, a 32 x 32
    camera) at the fast dry-run tier's sizes for `sizes` ranks, on this
    mesh (one rank: mesh None): collect, the gathered ring, one update,
    then one evaluation wave of the policy. -> as `trainer_rank`, the
    ring's frames as float32, then the evaluation's success rate."""
    import dataclasses

    from gaddpg_tpu_torch.agents.state import state_tensors
    from gaddpg_tpu_torch.parallel.dryrun import tier_config, tier_library
    from gaddpg_tpu_torch.replay.buffer import gather_buffer
    from gaddpg_tpu_torch.train.loop import Trainer
    from torch_image_common import S

    cfg = tier_config(sizes, output_dir)
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, use_image=True, domain_rand=True),
        agent=dataclasses.replace(cfg.agent, use_image=True, image_size=S))
    tr = Trainer(cfg, lib=tier_library(False), mesh=mesh, device="cpu")
    roll = tr.collect()
    ring = {k: _np(v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in gather_buffer(tr.buffer).items()}
    metrics = tr.train_iter()
    rate, _ = tr.evaluate(episodes=1)
    return (roll, ring, metrics, tr.update_step, [_np(t) for t in state_tensors(tr.agent_state)],
            tr.buffer.image_state.shape[0], rate)


def image_update_rank(mesh, kind, cfg_kw, state_kw, batch, noise, stage_sizes):
    """`update_rank` for an image agent whose ResNets have `stage_sizes`
    blocks a stage (torch_image_common.SHALLOW in the update tests; the
    JAX side is built at the same depth)."""
    import functools

    from gaddpg_tpu_torch.models import resnet

    resnet.ResNet18Feature = functools.partial(resnet.ResNet18Feature, stage_sizes=stage_sizes)
    return update_rank(mesh, kind, cfg_kw, state_kw, batch, noise)
