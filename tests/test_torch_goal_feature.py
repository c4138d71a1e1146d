"""The grasp-pose side of the port against the JAX package: GoalFeature
(gaddpg_tpu/models/pointnet.py:252-270), its training step
(gaddpg_tpu/data/grasp_dataset.py:106), `visible_points`
(gaddpg_tpu/render/camera.py:207), `GraspDatasetGenerator`
(gaddpg_tpu/data/grasp_dataset.py:28) on the JAX function's own draws,
and the goal trees in `from_flax` and the port's checkpoints.

The library is two procedural objects with their unverified grasp
candidates (`asset_from_mesh(verify=False)`, equal in both packages).
The clouds are the JAX generator's: 512 rows, the valid points first and
all-zero rows after them, which FPS sees as exact ties (K1) and the
train SA level as duplicate slots (K5).

Bounds. GoalFeature's eval outputs within 2e-5 (tests/test_pallas_sa.py:45).
The train forward's outputs and running statistics, and the update's
running statistics, within 1e-5 (tests/test_pallas_sa_train.py:60) or,
where that is exceeded, within 8 times JAX's own spread when the cloud's
points move by one ulp up and down (`_nudge_rule`): the batch-statistics
BatchNorms compute E[z^2] - m^2 in float32 over thousands of SA rows and
over the B = 4 clouds of the FC trunk, and amplify last-bit differences
(ROADMAP.md Queue 3 (f)), and another order of float32 sums at every
layer moves the result further than one ulp on the inputs does
(measured: the train outputs 1.46e-3 off JAX where JAX's one-ulp spread
is 3.4e-4, 4.2 times; the grasp rig's labels 6.1 times, ROADMAP.md
Queue 3 (l)). The update's losses within 1e-3 relative (LOSS) and its
moves within MOVES, as tests/test_torch_learner.py holds the DDPG
update's. A rendered
cloud by rule (c) of ROADMAP.md Queue 3: a pixel edge of the z-buffer
may move a point, so at most 3% of a cloud's points may lack a point of
the other package's cloud within 1e-4, and the valid counts are within
1% + 2.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaddpg_tpu.data import grasp_dataset as jgd
from gaddpg_tpu.data import mesh_import as jmi
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.models.pointnet import GoalFeature as JaxGoalFeature
from gaddpg_tpu.render import camera as jcam
from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state, from_flax
from gaddpg_tpu_torch.agents.optim import AdamW
from gaddpg_tpu_torch.agents.state import (
    GOAL_ENCODER, _critic_pairs, _encoder_pairs, _encoder_stat_pairs, _goal_pairs,
    _goal_stat_pairs, _policy_pairs, goal_from_flax, goal_parameters,
)
from gaddpg_tpu_torch.data import grasp_dataset, mesh_import, procgen
from gaddpg_tpu_torch.envs import assets
from gaddpg_tpu_torch.render import camera
from gaddpg_tpu_torch.train.checkpoints import load_agent, save_agent

B = 4
LR = 1e-3
POINT_TOL = 1e-4
EDGE_SHARE = 0.03
TRAIN_TOL = 1e-5
CHAOS_FACTOR = 8.0
# the update's losses, relative: [6.1e-4 PM, 1.8e-4 BCE] (a scalar's own
# one-ulp spread can be near 0: the BCE's is 4.6e-6 here)
LOSS = dict(rtol=1e-3, atol=1e-5)


def _nudged_clouds(cloud):
    """The cloud with every point moved by one ulp up and down (the zero
    rows stay zero)."""
    return [np.where(cloud != 0, np.nextafter(cloud, np.float32(way)), cloud)
            for way in (np.inf, -np.inf)]


def _nudge_rule(label, got, want, nudged):
    """max |got - want| within TRAIN_TOL, or within CHAOS_FACTOR times the
    largest move of JAX's output `want` over its runs on nudged inputs."""
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max())
    spread = max(float(np.abs(np.asarray(n) - np.asarray(want)).max()) for n in nudged)
    assert err <= max(TRAIN_TOL, CHAOS_FACTOR * spread), (label, err, spread)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _adam(opt_state):
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    return {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


def _flax_tree(pairs):
    out = {}
    for t, path, transpose in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        v = t.detach().numpy()
        node[path[-1]] = v.T if transpose else v
    return out


def _miss_share(pts, ref):
    """Share of the rows of pts (n, 3) farther than POINT_TOL from every
    row of ref (m, 3)."""
    if len(pts) == 0:
        return 0.0
    d = np.sqrt(((pts[:, None, :].astype(np.float64) - ref[None]) ** 2).sum(-1)).min(axis=1)
    return float((d > POINT_TOL).mean())


def _clouds_agree(cloud, valid, jcloud, jvalid):
    """Rule (c) on (B, P, 3) clouds with (B, P) valid masks."""
    for b in range(len(cloud)):
        n, jn = int(valid[b].sum()), int(jvalid[b].sum())
        assert abs(n - jn) <= 0.01 * jn + 2, (b, n, jn)
        p, r = cloud[b][valid[b]], jcloud[b][jvalid[b]]
        assert _miss_share(p, r) <= EDGE_SHARE and _miss_share(r, p) <= EDGE_SHARE, b
        # invalid rows are zero
        assert not cloud[b][~valid[b]].any()


@pytest.fixture(scope="module")
def libs():
    entries = {s: (mesh_import.asset_from_mesh(procgen.random_proc_mesh(s)[0], seed=s,
                                               verify=False),
                   jmi.asset_from_mesh(procgen.random_proc_mesh(s)[0], seed=s, verify=False))
               for s in (0, 1)}
    names = ["a", "b"]
    return (mesh_import.extend_library(assets.empty_library(), [e[0] for e in entries.values()],
                                       names),
            jmi.extend_library(jassets.empty_library(), [e[1] for e in entries.values()], names))


@pytest.fixture(scope="module")
def jax_gen(libs):
    return jgd.GraspDatasetGenerator(libs[1])


def _jax_draws(jax_gen, key, batch):
    """The draws of `jax_gen.sample(key, batch)`, rebuilt from its key
    splits (gaddpg_tpu/data/grasp_dataset.py:81-124)."""
    lib = jax_gen.lib

    def one(k, obj_idx):
        k_cloud, k_pick, k_pos, k_lab, k_neg = jax.random.split(k, 5)
        k1, k2, k3 = jax.random.split(k_cloud, 3)
        gv = lib.grasp_valid[obj_idx]
        probs = gv / jnp.maximum(gv.sum(), 1)
        kp1, kp2 = jax.random.split(k_pos)
        kn1, kn2 = jax.random.split(k_neg)
        kn21, kn22 = jax.random.split(kn2)
        return {
            "theta": jax.random.uniform(k1, (), minval=0.2, maxval=1.2),
            "phi": jax.random.uniform(k2, (), minval=0, maxval=2 * jnp.pi),
            "radius": jax.random.uniform(k3, (), minval=0.3, maxval=0.6),
            "grasp_idx": jax.random.choice(k_pick, gv.shape[0], p=probs),
            "label_u": jax.random.uniform(k_lab, ()),
            "pos_dt": jax.random.normal(kp1, (3,)), "pos_de": jax.random.normal(kp2, (3,)),
            "neg_t_mag": jax.random.uniform(kn1, (), minval=0.03, maxval=0.10),
            "neg_r_mag": jax.random.uniform(kn1, (), minval=0.4, maxval=1.2),
            "neg_dt": jax.random.normal(kn21, (3,)), "neg_de": jax.random.normal(kn22, (3,)),
        }

    ks = jax.random.split(key, batch)
    obj_idx = jax.random.randint(jax.random.fold_in(key, 99), (batch,), 0, lib.num_objects)
    out = jax.vmap(one)(ks, obj_idx)
    out["obj_idx"] = obj_idx
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


ORDER = ("obj_idx", "theta", "phi", "radius", "grasp_idx", "label_u", "pos_dt", "pos_de",
         "neg_t_mag", "neg_r_mag", "neg_dt", "neg_de")


@pytest.fixture(scope="module")
def batches(libs, jax_gen):
    """Two generator batches (JAX's, on keys 1 and 2) and the port's
    batches from the same draws."""
    gen = grasp_dataset.GraspDatasetGenerator(libs[0], device="cpu")
    out = []
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        want = {k: np.asarray(v) for k, v in jax_gen.sample(key, batch=B).items()}
        draws = _jax_draws(jax_gen, key, B)
        out.append((want, gen.batch(*(draws[k] for k in ORDER))))
    return out


def test_generator_matches_jax_on_its_draws(batches):
    for want, got in batches:
        np.testing.assert_array_equal(got["obj_idx"].numpy(), want["obj_idx"])
        np.testing.assert_array_equal(got["label"].numpy(), want["label"])
        g, w = got["grasp"].numpy(), want["grasp"]
        # q and -q are one rotation
        dq = np.minimum(np.abs(g[:, :4] - w[:, :4]).max(1), np.abs(g[:, :4] + w[:, :4]).max(1))
        assert dq.max() <= 1e-5 and np.abs(g[:, 4:] - w[:, 4:]).max() <= 1e-6
        _clouds_agree(got["cloud"].numpy(), got["cloud_valid"].numpy(), want["cloud"],
                      want["cloud_valid"])
        # the clouds carry zero rows: FPS ties and repeated K5 slots
        assert (~got["cloud_valid"]).any()


def test_generator_draws_are_batched_and_seeded(libs):
    gen = grasp_dataset.GraspDatasetGenerator(libs[0], device="cpu")
    a = gen.sample(torch.Generator().manual_seed(3), batch=16)
    b = gen.sample(torch.Generator().manual_seed(3), batch=16)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["cloud"].shape == (16, 512, 3) and a["grasp"].shape == (16, 7)
    # every picked grasp is a valid one of its object
    d = gen.draws(torch.Generator().manual_seed(4), 64)
    assert bool(libs[0].grasp_valid[d["obj_idx"], d["grasp_idx"]].all())
    assert set(a["label"].tolist()) <= {0.0, 1.0}


def test_visible_points_matches_jax(libs):
    """Batched visible_points with a valid mask against JAX's per view."""
    rng = np.random.RandomState(0)
    cam, jc = camera.CameraParams(width=64, height=64), jcam.CameraParams(width=64, height=64)
    pts = np.asarray(libs[1].surface_points)[[0, 1, 0]]
    valid = rng.rand(3, pts.shape[1]) < 0.8
    poses = []
    for eye in ([0.3, 0.0, 0.2], [0.0, -0.4, 0.3], [0.25, 0.25, -0.1]):
        eye = np.asarray(eye)
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, np.cross(z, x), z, eye
        poses.append(np.linalg.inv(T))
    inv = np.asarray(poses, np.float32)
    got, got_v = camera.visible_points(cam, torch.from_numpy(inv), torch.from_numpy(pts),
                                       torch.from_numpy(valid), max_points=256)
    want = [jcam.visible_points(jc, jnp.asarray(inv[b]), jnp.asarray(pts[b]),
                                jnp.asarray(valid[b]), max_points=256) for b in range(3)]
    _clouds_agree(got.numpy(), got_v.numpy(), np.stack([np.asarray(w[0]) for w in want]),
                  np.stack([np.asarray(w[1]) for w in want]))
    # the mask drops points: fewer hits than without it
    _, all_v = camera.visible_points(cam, torch.from_numpy(inv), torch.from_numpy(pts),
                                     max_points=256)
    assert int(got_v.sum()) < int(all_v.sum())


@pytest.fixture(scope="module")
def jax_goal():
    goal = JaxGoalFeature()
    variables = goal.init(jax.random.PRNGKey(0), jnp.zeros((1, 512, 3)), train=False)
    return goal, _np(variables["params"]), _np(variables["batch_stats"])


def test_goal_feature_matches_jax(jax_goal, batches):
    goal, params, stats = jax_goal
    port = goal_from_flax(params, stats, device="cpu")
    cloud = batches[0][0]["cloud"]
    (qt, conf) = goal.apply({"params": params, "batch_stats": stats}, cloud, train=False)
    with torch.no_grad():
        got_qt, got_conf = port(torch.from_numpy(np.array(cloud)))
    np.testing.assert_allclose(got_qt.numpy(), np.asarray(qt), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(conf), rtol=2e-5, atol=2e-5)
    assert np.allclose(np.linalg.norm(got_qt.numpy()[:, :4], axis=1), 1.0, atol=1e-6)

    def train(c):
        (qt, conf), mut = goal.apply({"params": params, "batch_stats": stats}, c, train=True,
                                     mutable=["batch_stats"])
        return qt, conf, _np(mut["batch_stats"])

    qt, conf, new_stats = train(cloud)
    nudged = [train(c) for c in _nudged_clouds(cloud)]
    with torch.no_grad():
        got_qt, got_conf, got_stats = port(torch.from_numpy(np.array(cloud)), train=True)
    _nudge_rule("qt", got_qt.numpy(), qt, [n[0] for n in nudged])
    _nudge_rule("conf", got_conf.numpy(), conf, [n[1] for n in nudged])
    assert len(got_stats) == len(port.encoder.batch_norms())
    port.encoder.update_running_stats(got_stats)
    for t, path, _ in _goal_stat_pairs(port):
        _nudge_rule(path, t.numpy(), _leaf(new_stats, path), [_leaf(n[2], path) for n in nudged])


# the update's moves: at most 2e-3 of the elements off by more than 0.5 lr
# [9.8e-4; 1.4e-2 past 0.1 lr, the SA levels' gradients carrying the
# amplified BatchNorm rounding], tests/test_torch_learner.py's bound with
# the actor term on, (0.5, 2e-2), tightened tenfold
MOVES = dict(threshold=0.5, fraction=2e-3)


def _moves_within(port, before, after, lr, threshold, fraction):
    """Each leaf's move against JAX's: at most `fraction` of the elements
    off by more than threshold * lr; a Dense bias that feeds a
    BatchNorm (gradient 0 up to rounding) moves by at most lr on both
    sides (tests/test_torch_learner.py's rule)."""
    off = total = 0
    for t, path, transpose in _goal_pairs(port):
        got = t.detach().numpy().T if transpose else t.detach().numpy()
        want, prev = _leaf(after, path), _leaf(before, path)
        if path[0] == GOAL_ENCODER and path[-2].startswith("Dense") and path[-1] == "bias":
            for side in (got, want):
                assert np.abs(side - prev).max() <= lr * (1 + 1e-3), path
            continue
        off += int((np.abs((got - prev) - (want - prev)) > threshold * lr).sum())
        total += got.size
    assert off <= fraction * total, f"{off} of {total} moves differ"


def test_goal_feature_update_matches_jax(jax_goal, batches):
    """make_goal_feature_update against JAX's with optax.adamw, from a
    common state with carried Adam moments (JAX's first update)."""
    goal, params, stats = jax_goal
    tx = optax.adamw(LR, eps=1e-5, weight_decay=1e-5)
    update = jgd.make_goal_feature_update(goal, tx)
    first, second = ({k: jnp.asarray(v) for k, v in w.items()} for w, _ in batches)
    p1, s1, o1, _ = update(params, stats, tx.init(params), first)
    p1, s1 = _np(p1), _np(s1)
    p2, s2, _, want = update(p1, s1, o1, second)
    nudged = [update(p1, s1, o1, dict(second, cloud=jnp.asarray(c)))
              for c in _nudged_clouds(np.asarray(second["cloud"]))]

    port = goal_from_flax(p1, s1, device="cpu")
    opt = AdamW(goal_parameters(port), LR, eps=1e-5, weight_decay=1e-5)
    adam = _adam(o1)
    with torch.no_grad():
        for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
            for t, (_, path, transpose) in zip(moments, _goal_pairs(port)):
                v = _leaf(adam[key], path)
                t.copy_(torch.from_numpy(v.T if transpose else v))
    opt.count = adam["count"]
    got = grasp_dataset.make_goal_feature_update(port, opt)(
        {k: torch.from_numpy(np.array(v)) for k, v in batches[1][0].items()})
    for k in ("pm_loss", "bce_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS, err_msg=k)
    assert opt.count == 2
    _moves_within(port, p1, _np(p2), LR, **MOVES)
    for t, path, _ in _goal_stat_pairs(port):
        _nudge_rule(path, t.numpy(), _leaf(_np(s2), path),
                    [_leaf(_np(n[1]), path) for n in nudged])


def test_from_flax_and_checkpoints_carry_the_goal(jax_goal, tmp_path):
    """from_flax takes the goal trees and Adam state; save_agent and
    load_agent carry them."""
    goal, params, stats = jax_goal
    cfg = AgentConfig()
    base = create_agent_state(cfg, 96, generator=torch.Generator().manual_seed(1), device="cpu")
    feat = {n: _flax_tree(_encoder_pairs(getattr(base.feat, n)))
            for n in ("encoder", "value_encoder")}
    feat_stats = {n: _flax_tree(_encoder_stat_pairs(getattr(base.feat, n)))
                  for n in ("encoder", "value_encoder")}
    tx = optax.adamw(LR, eps=1e-5, weight_decay=1e-5)
    rng = np.random.RandomState(0)
    opt_state = tx.init(params)
    fake = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    _, opt_state = tx.update(fake, opt_state, params)
    state = from_flax(feat, feat_stats, _flax_tree(_policy_pairs(base.policy)), cfg,
                      device="cpu", critic_params=_flax_tree(_critic_pairs(base.critic)),
                      goal_params=params, goal_stats=stats, goal_opt=_adam(opt_state))
    for t, path, transpose in _goal_pairs(state.goal) + _goal_stat_pairs(state.goal):
        want = _leaf(params if path[-1] not in ("mean", "var") else stats, path)
        np.testing.assert_array_equal(t.detach().numpy(), want.T if transpose else want)
    assert state.goal_opt.count == 1
    assert state.goal_opt.lr == cfg.feature_lr
    assert any(float(m.abs().max()) > 0 for m in state.goal_opt.mu)

    save_agent(state, str(tmp_path))
    loaded = load_agent(base, str(tmp_path))
    for a, b in zip(goal_parameters(loaded.goal), goal_parameters(state.goal)):
        assert torch.equal(a, b)
    for a, b in zip(loaded.goal_opt.nu, state.goal_opt.nu):
        assert torch.equal(a, b)
    assert loaded.goal_opt.count == 1
    # the copy steps its own goal parameters
    copy = state.to("cpu")
    assert all(p is not q for p, q in zip(copy.goal_opt.params, state.goal_opt.params))
    assert all(p is q for p, q in zip(copy.goal_opt.params, goal_parameters(copy.goal)))
