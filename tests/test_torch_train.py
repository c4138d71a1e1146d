"""The train slice of the port (`gaddpg_tpu_torch.train`) on the CPU: the
schedules and the config against the JAX package's, one rollout of
`RolloutWorker` against the JAX `RolloutWorker._rollout` on the JAX
draws, and the `Trainer` fast tier of `__graft_entry__._dryrun_impl`
(one collect, one train_iter) with `run` writing a checkpoint.

Shapes are the dryrun's (`__graft_entry__.py:146-152`): a 32x32 camera,
58 sampled points, 10 substeps, `max_steps=3`, a fat box.

The rollout comparison: the JAX rollout runs as one jitted program from
one key; its draws are re-derived from that key by the same splits, and
its observation resample indices (drawn below each env's reservoir
count, which only the program knows) are read from the program through a
debug callback on `build_point_state`; so is its carry (the reset, and
what goes into and comes out of each `step_batched`). The port's rollout
takes those draws as tensors: flags, masks and episode lengths are equal
and the first transition is equal up to float32 rounding. Then every
step is held from the JAX carry: the port's `RolloutWorker._step` on the
JAX states, observations and done flags going into it, against the JAX
transition and against the JAX `step_batched` from the same state at
tests/test_torch_env.py's bounds. Plan lengths are 3 on this batch, so
the expert episode end (t >= plan_len + 3) lies past the 4-step horizon.
"""

import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.agents.state import create_agent_state as jax_create_agent_state
from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import PandaGraspEnv as JaxPandaGraspEnv
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.envs import grasp_env as jax_grasp_env
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.render.camera import CameraParams as JaxCameraParams
from gaddpg_tpu.train import config as jax_config
from gaddpg_tpu.train import schedules as jax_schedules
from gaddpg_tpu.train.rollout import RolloutWorker as JaxRolloutWorker
import gaddpg_tpu_torch
from gaddpg_tpu_torch.agents import AgentConfig, from_flax
from gaddpg_tpu_torch.envs.assets import LIBRARY_FIELDS, box_asset, library_from_arrays
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, Observation, PandaGraspEnv
from gaddpg_tpu_torch.parallel import Mesh
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from gaddpg_tpu_torch.train import (
    RolloutWorker, Trainer, config, explore_schedule, load_config, noise_schedule,
)
from gaddpg_tpu_torch.train.checkpoints import load_agent
from gaddpg_tpu_torch.train.metrics import MetricLogger, ObjectPerformance
from torch_env_common import assert_phys_close, observe_draws, point_state_mismatch, port_state

DRYRUN_ENV = dict(camera=dict(width=32, height=32), uniform_num_pts=58, pc_capacity=128,
                  new_points_per_step=32, settle_substeps=20, max_steps=3, reset_tries=2,
                  retract_lift_steps=2, use_planner=False)
N_ENVS = 6
# the dryrun's schedule, with DAgger, DART and the expert start reaching
# into its 4-step horizon so that every mask is live
ROLLOUT = {"num_envs": N_ENVS, "max_steps": 3, "extend_steps": 1, "dagger": True,
           "dagger_min_step": 0, "dagger_ratio": 0.5, "dart_min_step": 0, "dart_max_step": 4,
           "dart_ratio": 0.5, "expert_init_min_step": 0, "expert_init_max_step": 3}
EXPLORE, NOISE = 0.5, 3.0


A_DT = 30.0 * 2e-3  # the arm servo's velocity quantum, arm_acc_limit * dt


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def env_params(cls, physics_cls, camera_cls, planner=False):
    kw = dict(DRYRUN_ENV, camera=camera_cls(**DRYRUN_ENV["camera"]), use_planner=planner)
    return cls(physics=physics_cls(substeps=10), **kw)


def port_env_params(planner=False):
    return env_params(EnvParams, PhysicsParams, CameraParams, planner)


# -- schedules and config ---------------------------------------------------------

@pytest.mark.parametrize("step", [0, 4000, 4001, 50000, 10**6])
def test_schedules_match_jax(step):
    cfg, ref = config.TrainConfig(), jax_config.TrainConfig()
    assert explore_schedule(step, cfg) == jax_schedules.explore_schedule(step, ref)
    assert noise_schedule(step, cfg) == jax_schedules.noise_schedule(step, ref)


def _asdict(cfg):
    return {k: (v if not dataclasses.is_dataclass(v) else _asdict(v))
            for k, v in ((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg))}


@pytest.mark.parametrize("case", ["defaults", "overrides", "yaml", "bc", "self_supervision"])
def test_load_config_matches_jax(case, tmp_path):
    kw = {}
    if case == "overrides":
        kw = dict(overrides={"num_envs": 1024, "output_dir": "o", "use_planner": False,
                             "ONPOLICY_MEMORY_SIZE": -1, "lr": 1e-4, "mix_milestones": [1, 2]},
                  policy="DDPG")
    elif case == "yaml":
        path = tmp_path / "exp.yaml"
        path.write_text("RL_MEMORY_SIZE: 5000\nRL_TRAIN:\n  batch_size: 32\n  onpolicy: true\n"
                        "  RL: true\n  DAGGER_RATIO: 0.25\n  gamma: 0.9\n  num_clutter: 0\n"
                        "RL_MAX_STEP_ENV: 15\n")
        kw = dict(path=str(path))
    elif case == "bc":
        kw = dict(policy="BC")
    elif case == "self_supervision":
        kw = dict(overrides={"self_supervision": True})
    assert _asdict(load_config(**kw)) == _asdict(jax_config.load_config(**kw))


def test_yaml_is_imported_only_for_a_file(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert load_config(overrides={"num_envs": 8}).num_envs == 8
    with pytest.raises(ImportError, match="yaml"):
        load_config(path="exp.yaml")


def test_metrics(tmp_path):
    log = MetricLogger(str(tmp_path))
    log.log(3, {"a": 1.0})
    log.log(4, {"a": 3.0})
    assert log.smoothed("a") == 2.0
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2
    perf = ObjectPerformance(["box", "cyl"])
    perf.update([0, 1, 1], [1.0, 0.0, 1.0], [True, True, False])
    assert perf.overall == 0.5 and "TOTAL" in perf.table()


# -- the rollout against the JAX package --------------------------------------------

def _jax_rollout_and_draws(seed, planner=False):
    """(JAX rollout outputs as numpy, port AgentState, draws for the port,
    the port's library, the JAX rollout's carry: {"reset": (states,
    observations) of the reset, "steps": {first step key: (states,
    actions, keys, observations and done flags out) of each in-scan
    `step_batched`}}, numpy leaves)."""
    jax_lib = jassets.box_asset(0.06, 0.06, 0.14)
    jparams = env_params(JaxEnvParams, JaxPhysicsParams, JaxCameraParams, planner)
    jenv = JaxPandaGraspEnv(jparams, jax_lib)
    jcfg = dataclasses.replace(jax_config.load_config(overrides=ROLLOUT), env=jparams)
    acfg = JaxAgentConfig()
    jstate = jax_create_agent_state(jax.random.PRNGKey(seed), acfg, npoints=64)
    worker = JaxRolloutWorker(jenv, acfg, jcfg)

    counts = {}  # obs resample key -> reservoir count the program drew below

    def record(key, n_valid):
        counts[tuple(np.asarray(key).tolist())] = int(n_valid)

    original = jax_grasp_env.build_point_state

    def recording(pc, key, ef_pose_inv, num_pts=1024):
        jax.debug.callback(record, key, jnp.minimum(pc.count, pc.points.shape[0]))
        return original(pc, key, ef_pose_inv, num_pts)

    carry = {"steps": {}}

    def record_reset(states, obs):
        carry["reset"] = to_numpy((states, obs))

    def record_step(states, actions, keys, new_obs, new_done):
        carry["steps"][tuple(np.asarray(keys[0]).tolist())] = to_numpy(
            (states, actions, keys, new_obs, new_done))

    reset_all, step_batched = worker._reset_all, jenv.step_batched

    def recording_reset(key, num_envs):
        out = reset_all(key, num_envs)
        jax.debug.callback(record_reset, *out)
        return out

    def recording_step(states, actions, keys, requery_goal=None):
        out = step_batched(states, actions, keys, requery_goal=requery_goal)
        jax.debug.callback(record_step, states, actions, keys, out[1], out[3])
        return out

    key = jax.random.PRNGKey(100 + seed)
    jax_grasp_env.build_point_state = recording
    worker._reset_all, jenv.step_batched = recording_reset, recording_step
    try:
        out = to_numpy(worker._rollout(jstate, key, jnp.asarray(EXPLORE), jnp.asarray(NOISE)))
    finally:
        jax_grasp_env.build_point_state = original
        del worker._reset_all, jenv.step_batched

    p, n, horizon = jparams, N_ENVS, jcfg.rollout_horizon
    tensor = lambda x: torch.as_tensor(np.array(x))  # noqa: E731

    def obs_draws(obs_keys):
        keep, idx = [], []
        for k in obs_keys:
            k1, k2, _ = jax.random.split(k, 3)
            keep.append(np.asarray(jax.random.uniform(k1, (p.new_points_per_step,))))
            c = counts[tuple(np.asarray(k2).tolist())]
            idx.append(np.asarray(jax.random.randint(k2, (p.uniform_num_pts,), 0, max(c, 1))))
        return {"keep_u": tensor(np.stack(keep)), "idx": tensor(np.stack(idx))}

    k_reset, k_flags, k_scan, _ = jax.random.split(key, 4)
    env_keys = jax.random.split(k_reset, n)
    lo_hi = {"x": (1, p.spawn_x), "y": (2, p.spawn_y), "yaw": (3, (-np.pi, np.pi)),
             "theta": (4, (0.0, 2 * np.pi / 3)), "phi": (5, (np.pi / 2, 3 * np.pi / 2)),
             "r": (6, (p.init_near, p.init_far))}
    reset = []
    for r in range(p.reset_tries):
        tries = [jax.random.split(k, 2 * p.reset_tries) for k in env_keys]
        split = [jax.random.split(k[2 * r], 12) for k in tries]
        draw = lambda f: tensor(np.stack([np.asarray(f(ks)) for ks in split]))  # noqa: E731
        scene = {name: draw(lambda ks, i=i, b=b: jax.random.uniform(ks[i], (), minval=b[0],
                                                                     maxval=b[1]))
                 for name, (i, b) in lo_hi.items()}
        scene["jitter"] = draw(lambda ks: jax.random.uniform(ks[7], (3,), minval=-0.03,
                                                             maxval=0.03))
        scene["obj_idx"] = draw(lambda ks: jax.random.randint(ks[0], (), 0,
                                                              jax_lib.num_objects))
        reset.append((scene, obs_draws([jax.random.fold_in(k[2 * r + 1], 17) for k in tries])))
    kf1, kf2 = jax.random.split(k_flags)
    draws = {"reset": reset,
             "explore_u": tensor(jax.random.uniform(kf1, (n,))),
             "expert_init_steps": tensor(jax.random.randint(
                 kf2, (n,), jcfg.expert_init_min_step, max(jcfg.expert_init_max_step, 1))),
             "steps": []}
    k = k_scan
    for _ in range(horizon):
        k, k1, k2, k3, k4, k5, k_step = jax.random.split(k, 7)
        perturb = jnp.concatenate([jax.random.uniform(k4, (n, 3), minval=-0.04, maxval=0.04),
                                   jax.random.uniform(k5, (n, 3), minval=-0.2, maxval=0.2)], -1)
        draws["steps"].append({
            "noise": tensor(jax.random.uniform(k1, (n, 6))),
            "dagger_u": tensor(jax.random.uniform(k2, (n,))),
            "dart_u": tensor(jax.random.uniform(k3, (n,))),
            "perturb": tensor(perturb),
            "env": obs_draws([jax.random.fold_in(sk, 1) for sk in jax.random.split(k_step, n)]),
        })
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(t))  # noqa: E731
    state = from_flax(np_tree(jstate.feat_params), np_tree(jstate.feat_stats),
                      np_tree(jstate.policy_params), AgentConfig(), device="cpu")
    lib = library_from_arrays(jax_lib.names, **{f: np.asarray(getattr(jax_lib, f))
                                                 for f in LIBRARY_FIELDS})
    return out, state, draws, lib, carry, jenv


@pytest.fixture(scope="module")
def jax_rollout():
    return _jax_rollout_and_draws(0)


@pytest.fixture(scope="module")
def worker(jax_rollout):
    env = PandaGraspEnv(port_env_params(), jax_rollout[3], device="cpu")
    cfg = dataclasses.replace(load_config(overrides=ROLLOUT), env=port_env_params())
    return RolloutWorker(env, AgentConfig(), cfg, device="cpu")


@pytest.fixture(scope="module")
def rollouts(jax_rollout, worker):
    out, state, draws = jax_rollout[:3]
    mine = worker.rollout(state, EXPLORE, NOISE, draws=draws)
    return mine, out


EXACT = ("expert_flags", "perturb_flags", "timestep", "target_idx", "reward", "terminal",
         "grasp")


def test_rollout_flags_and_masks_match_jax(rollouts):
    (episodes, valid, rewards, stats), (j_eps, j_valid, j_rewards, j_stats) = rollouts
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    for k in ("explore_env", "valid_scene", "episode_len", "collided"):
        np.testing.assert_array_equal(stats[k].numpy(), j_stats[k], err_msg=k)
    np.testing.assert_array_equal(rewards.numpy(), j_rewards)
    live = j_valid
    for k in EXACT:
        np.testing.assert_array_equal(episodes[k].numpy()[live], j_eps[k][live], err_msg=k)
    # the case is what it claims: explore and expert envs, DAgger (flag
    # 2), DART and the expert start all happened on valid steps
    flags = j_eps["expert_flags"][live]
    assert {0.0, 1.0, 2.0} <= set(flags.tolist()), flags
    assert j_eps["perturb_flags"][live].any()
    assert live.sum() >= 8


def test_rollout_continuous_fields_match_jax(rollouts):
    """The rollout's first transition (the reset's observation, the
    policy with its noise, the expert, the DART and DAgger selects):
    float32 rounding only (4.5e-7 measured). Later steps are held one at
    a time from the JAX carry (test_rollout_steps_from_the_jax_carry):
    from the reset on, the arm is redundant (7 joints for a 6-DoF hand
    pose) and the reset's IK start may pick another near-tied seed (ROADMAP
    Queue 3, not fault (b)) that reaches the same hand pose in another
    posture, from which the next step's IK lands elsewhere."""
    (episodes, _, _, _), (j_eps, _, _, _) = rollouts
    for k in ("point_state", "state_pose", "goal", "expert_action", "action"):
        np.testing.assert_allclose(episodes[k].numpy()[:, 0], j_eps[k][:, 0], rtol=0,
                                   atol=1e-5, err_msg=k)


def _port_obs(obs):
    return Observation(**{f.name: torch.as_tensor(np.array(getattr(obs, f.name)))
                          for f in dataclasses.fields(Observation)})


def test_rollout_steps_from_the_jax_carry(jax_rollout, worker):
    """Every step of the rollout from the JAX rollout's own carry (the
    states, observations and done flags going into that step, with its
    draws): the masks, flags and the chosen action against the JAX
    rollout's transition, and the env step (state, observation, done,
    collision) against the JAX `step_batched` from the same state, with
    the same actions and keys, at tests/test_torch_env.py's bounds."""
    (j_eps, j_valid, _, j_stats), state, draws, _, carry, jenv = jax_rollout
    step = jax.jit(jenv.step_batched)
    p = worker.env.p
    states0, obs = carry["reset"]
    ctx = {"explore_env": torch.as_tensor(np.array(j_stats["explore_env"])),
           "expert_init_steps": draws["expert_init_steps"].to(torch.int64),
           "plan_len": torch.as_tensor(np.array(jax.vmap(jenv.expert_steps)(states0))),
           "noise_scale": NOISE}
    np.testing.assert_array_equal(
        worker.env.expert_steps(port_state(states0)).numpy(), ctx["plan_len"].numpy())
    k_scan = jax.random.split(jax.random.PRNGKey(100), 4)[2]
    done = np.zeros(N_ENVS, bool)
    shares = []
    for t, d in enumerate(draws["steps"]):
        k_scan, *_, k_step = jax.random.split(k_scan, 7)
        jst, j_act, keys, scan_obs, scan_done = carry["steps"][tuple(np.asarray(
            jax.random.split(k_step, N_ENVS)[0]).tolist())]
        # the carry is the JAX rollout's: its transition shows it
        np.testing.assert_array_equal(obs.point_state, j_eps["point_state"][:, t])
        np.testing.assert_array_equal(~done & j_stats["valid_scene"], j_valid[:, t])
        jnew, jobs, _, jdone, jinfo = to_numpy(step(jst, j_act, keys))
        env_draws = observe_draws(jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                                  jnew.pc.count, p.pc_capacity, p.new_points_per_step,
                                  p.uniform_num_pts)
        st, ob, dn, tr, keep = worker._step(
            state, ctx, t, port_state(jst), _port_obs(obs), torch.as_tensor(done),
            (d["noise"], d["dagger_u"], d["dart_u"], d["perturb"], env_draws))
        for k in ("expert_flags", "perturb_flags", "timestep", "target_idx", "state_pose",
                  "goal"):
            np.testing.assert_array_equal(tr[k].numpy(), j_eps[k][:, t], err_msg=f"{k} {t}")
        for k in ("expert_action", "action"):
            np.testing.assert_allclose(tr[k].numpy(), j_eps[k][:, t], rtol=0, atol=1e-5,
                                       err_msg=f"{k} {t}")
        np.testing.assert_array_equal(keep.numpy(), ~done)
        # the env step from the carry; finished envs keep theirs
        kept = lambda new, old: jax.tree_util.tree_map(  # noqa: E731
            lambda a, b: np.where(done.reshape(-1, *[1] * (np.ndim(a) - 1)), b, a), new, old)
        jnew, jobs = kept(jnew, jst), kept(jobs, obs)
        np.testing.assert_allclose(st.phys.arm.q_target.numpy(), jnew.phys.arm.q_target,
                                   atol=1e-5, err_msg=str(t))
        assert_phys_close(st.phys, jnew.phys, {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4,
                                               "angvel": 2e-3, "fingers": 2e-5,
                                               "arm_q": 2 * A_DT * 2e-3})
        np.testing.assert_allclose(st.phys.arm.qd.numpy(), jnew.phys.arm.qd,
                                   atol=2 * A_DT + 1e-3)
        np.testing.assert_array_equal(st.collided.numpy(), jnew.collided)
        np.testing.assert_array_equal(tr["collide"].numpy(), jinfo["collided"])
        for k in ("ef_pose", "goal_pose"):
            np.testing.assert_allclose(getattr(ob, k).numpy(), getattr(jobs, k), rtol=0,
                                       atol=2e-5, err_msg=f"{k} {t}")
        shares.append(point_state_mismatch(ob.point_state, jobs.point_state))
        expert_end = ~j_stats["explore_env"] & (t >= ctx["plan_len"].numpy() + 3.0)
        np.testing.assert_array_equal(dn.numpy(), done | jdone | expert_end, err_msg=str(t))
        # the next carry: the JAX rollout's own step
        obs = kept(scan_obs, obs)
        done = done | scan_done | expert_end
    assert max(shares) <= 0.03, shares


# -- the Trainer fast tier -----------------------------------------------------------

def dryrun_config(tmp_path, **over):
    cfg = load_config(overrides=dict({
        "num_envs": 4, "max_steps": 3, "extend_steps": 1, "batch_size": 4,
        "updates_per_iter": 1, "buffer_size": 32, "fill_data_step": 0,
        "explore_ratio": 0.5, "explore_cap": 0.5, "output_dir": str(tmp_path)}, **over),
        policy=over.pop("policy", "DDPG"))
    return dataclasses.replace(cfg, env=port_env_params())


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tr = Trainer(dryrun_config(tmp_path_factory.mktemp("trainer")),
                 lib=box_asset(0.06, 0.06, 0.14), device="cpu")
    stats = tr.collect()
    for _ in range(2):  # scene validity is stochastic on tiny scenes
        if stats["buffer_idx"] > 0:
            break
        stats = tr.collect()
    return tr, stats


def test_trainer_fast_tier(trainer):
    tr, stats = trainer
    assert stats["buffer_idx"] > 0 and stats["env_steps"] == tr.buffer.total_env_step
    n = tr.buffer.filled
    ends = tr.buffer.episode_map[:n]
    assert (ends >= torch.arange(n)).all() and (ends < n).all()
    train_stats = tr.train_iter()
    assert train_stats and all(np.isfinite(v) for v in train_stats.values()), train_stats
    assert tr.update_step == 1


def test_trainer_run_writes_a_checkpoint(tmp_path):
    tr = Trainer(dryrun_config(tmp_path, batch_size=1), lib=box_asset(0.06, 0.06, 0.14),
                 device="cpu")
    tr.run(max_iters=1, log_every=1)
    assert tr.update_step == 1
    assert (tmp_path / "metrics.jsonl").exists()
    loaded = load_agent(tr.agent_state, str(tmp_path))
    assert loaded.update_step == 1
    for a, b in zip(loaded.feat.state_dict().values(), tr.agent_state.feat.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name, opt in tr.agent_state.opt.items():
        assert loaded.opt[name].count == opt.count
        for a, b in zip(loaded.opt[name].nu, opt.nu):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert load_agent(tr.agent_state, str(tmp_path), "missing") is None


def test_trainer_mixes_the_online_buffer(trainer, tmp_path):
    tr = Trainer(dryrun_config(tmp_path, onpolicy=True, online_buffer_size=32,
                               online_buffer_ratio=0.5, explore_ratio=1.0, explore_cap=0.5),
                 lib=box_asset(0.06, 0.06, 0.14), device="cpu")
    for _ in range(4):
        tr.collect()
        if tr.buffer.filled >= 4 and tr.online_buffer.filled >= 2:
            break
    assert tr.buffer.filled and tr.online_buffer.filled
    # expert steps land in the main ring, explore steps in the online one
    assert (tr.online_buffer.expert_flags[:tr.online_buffer.filled] != 1).all()
    assert (tr.buffer.expert_flags[:tr.buffer.filled] == 1).all()


def test_trainer_evaluate(trainer):
    tr, _ = trainer
    rate, perf = tr.evaluate(episodes=1)
    assert 0.0 <= rate <= 1.0 and perf.table()


def test_unported_options_raise(tmp_path):
    """No option of the JAX package's loop is left to raise: a mesh and
    image mode under it are ported (tests/test_torch_dp_*.py), so a
    RolloutWorker takes an image agent on a mesh's env, and no module of
    the port raises NotImplementedError for an unported option."""
    lib = box_asset(0.06, 0.06, 0.14)
    mesh = Mesh(world=2, rank=0, device=torch.device("cpu"))
    cfg = dryrun_config(tmp_path)
    image_cfg = dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, use_image=True))
    env = PandaGraspEnv(cfg.env, lib, device="cpu", mesh=mesh)
    worker = RolloutWorker(env, image_cfg.agent, cfg, mesh=mesh, device="cpu")
    assert worker.agent_cfg.use_image and worker.num_envs == cfg.num_envs // 2
    package = os.path.dirname(gaddpg_tpu_torch.__file__)
    raising = [os.path.join(d, f) for d, _, files in os.walk(package) for f in files
               if f.endswith(".py") and "NotImplementedError" in open(os.path.join(d, f)).read()]
    assert raising == []
    tr = Trainer(cfg, lib=lib, device="cpu")
    # image mode is ported (tests/test_torch_image_agent.py)
    worker = RolloutWorker(tr.env, dataclasses.replace(tr.cfg.agent, use_image=True), tr.cfg,
                           device="cpu")
    assert worker.agent_cfg.use_image


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(dryrun_config(tmp_path), lib=box_asset(0.06, 0.06, 0.14))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutWorker(PandaGraspEnv(port_env_params(), box_asset(0.06, 0.06, 0.14),
                                    device="cpu"), AgentConfig(), dryrun_config(tmp_path))
