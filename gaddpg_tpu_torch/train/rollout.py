"""Batched episode rollout: N envs, one episode each (counterpart of
gaddpg_tpu/train/rollout.py; reference: core/train_online.py:207-321).

- a fraction of envs "explore" (roll the policy + noise), the rest roll
  the expert, the CHOMP plan or the goal servo (the reference's
  explore/expert episode split);
- explore envs may start with a few expert steps (expert_initial_state)
  and get DAgger expert-relabel steps (under the planner, replanned from
  the policy's state); expert envs get DART random
  perturbation steps flagged perturb (excluded from the critic loss);
- envs freeze once done; after the horizon every env runs the retract
  and the lift reward lands on its last valid transition, with the
  discounted-return backfill done at buffer insert;
- in image mode (`AgentConfig.use_image`) the policy reads the RGBDM
  observation and the episodes carry it as `image_state`.

The JAX package runs the horizon as one `lax.scan`; here it is a Python
loop over the T steps, each step one batched env step, with the same
per-env masked selects. Every random draw comes from a
`torch.Generator` or from `draws`, a structure of the draws as tensors
(the JAX package's, for parity):

    {"reset": [(scene draws, observation draws), ...] one pair per reset
               try, as `PandaGraspEnv.reset` takes them,
     "explore_u": (N,) U[0, 1): an env explores where below explore_frac,
     "expert_init_steps": (N,) int,
     "steps": [{"noise": (N, 6) the policy noise's raw draws,
                "dagger_u": (N,), "dart_u": (N,) U[0, 1),
                "perturb": (N, 6) the DART perturbation itself,
                "env": {"keep_u", "idx"} as `step_batched` takes them},
               ... one per step]}

`evaluate` takes {"reset": ..., "steps": [{"env": ...}, ...]}.

Under a data-parallel mesh (`RolloutWorker(mesh=)`, with an env built on
the same mesh) each rank runs num_envs / n envs: every draw is made for
the global batch and sliced (`parallel.mesh.draw_rows`), and `draws` are
the global batch's, sliced the same way, so that rank r's envs are envs
[r * N / n, (r + 1) * N / n) of the one-rank run. The results are this
rank's envs'.
"""

import torch

from gaddpg_tpu_torch.agents.ddpg import exploration_noise, make_select_action
from gaddpg_tpu_torch.envs.grasp_env import PandaGraspEnv, _where
from gaddpg_tpu_torch.parallel.mesh import shard_leading_axis, validate_dp_divisibility, world_of
from gaddpg_tpu_torch.utils.precision import resolve_device

# half-widths of the DART perturbation box (reference: env/panda_scene.py:1069-1076)
PERTURB_HIGH = (0.04, 0.04, 0.04, 0.2, 0.2, 0.2)


class RolloutWorker:
    """Env + policy selection as batched rollout and evaluation programs."""

    def __init__(self, env: PandaGraspEnv, agent_cfg, train_cfg, mesh=None, device="cuda"):
        validate_dp_divisibility(mesh, num_envs=train_cfg.num_envs)
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, the rollout on {self.device}")
        if env.mesh is not mesh:
            raise ValueError("the env and the rollout must be built on the same mesh")
        self.mesh = mesh
        self.num_envs = train_cfg.num_envs // world_of(mesh)  # this rank's
        self.env = env
        self.cfg = train_cfg
        self.agent_cfg = agent_cfg
        self.select_action = make_select_action(agent_cfg, self.device)

    def _policy_input(self, obs):
        """The policy's observation: the RGBDM image in image mode, else
        the point state (reference: experiments/config.py:105)."""
        return obs.image if self.agent_cfg.use_image else obs.point_state

    # ------------------------------------------------------------------
    def _draw(self, fn, generator, shape, *bounds):
        """As the env draws (`PandaGraspEnv._draw`: this rank's rows under
        a mesh); the env is on this rollout's device and mesh."""
        return self.env._draw(fn, generator, shape, *bounds)

    def _rand(self, generator, shape):
        return self._draw(torch.rand, generator, shape)

    def _step_draws(self, generator, draws, t, n):
        """(noise raw draws, dagger uniforms, DART uniforms, perturbation,
        env draws) of step t."""
        if draws is not None:
            d = draws["steps"][t]
            return (d["noise"].to(self.device), d["dagger_u"].to(self.device),
                    d["dart_u"].to(self.device), d["perturb"].to(self.device), d["env"])
        if self.agent_cfg.noise_type == "uniform":
            noise = self._rand(generator, (n, 6))
        else:
            noise = self._draw(torch.randn, generator, (n, 6))
        dagger_u, dart_u = self._rand(generator, (n,)), self._rand(generator, (n,))
        high = torch.tensor(PERTURB_HIGH, device=self.device)
        perturb = (self._rand(generator, (n, 6)) * 2.0 - 1.0) * high
        return noise, dagger_u, dart_u, perturb, None

    @torch.no_grad()
    def rollout(self, agent_state, explore_frac, noise_scale, generator=None, draws=None):
        """Returns (episodes (N, T, ...), valid (N, T), rewards (N,), stats),
        N this rank's envs."""
        cfg, env, dev = self.cfg, self.env, self.device
        n = self.num_envs
        draws = shard_leading_axis(self.mesh, draws)
        horizon = cfg.rollout_horizon
        explore_frac, noise_scale = float(explore_frac), float(noise_scale)

        states, obs = env.reset(n, generator, None if draws is None else draws["reset"])
        valid_scene = states.valid_scene

        if draws is not None:
            explore_u = draws["explore_u"].to(dev)
            expert_init_steps = draws["expert_init_steps"].to(dev, torch.int64)
        else:
            explore_u = self._rand(generator, (n,))
            expert_init_steps = self._draw(torch.randint, generator, (n,),
                                           cfg.expert_init_min_step,
                                           max(cfg.expert_init_max_step, 1))
        explore_env = explore_u < explore_frac
        plan_len = env.expert_steps(states)

        ctx = {"explore_env": explore_env, "expert_init_steps": expert_init_steps,
               "plan_len": plan_len, "noise_scale": noise_scale}
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        trans, keeps = [], []
        for t in range(horizon):
            states, obs, done, tr, keep = self._step(
                agent_state, ctx, t, states, obs, done,
                self._step_draws(generator, draws, t, n), generator)
            trans.append(tr)
            keeps.append(keep)

        episodes = {k: torch.stack([tr[k] for tr in trans], dim=1) for k in trans[0]}
        valid = torch.stack(keeps, dim=1) & valid_scene[:, None]

        # retract + lift reward on the last valid transition
        states, rewards = env.retract_batched(states)
        n_valid = valid.sum(dim=1)
        is_last = (torch.arange(horizon, device=dev)[None, :] == (n_valid - 1)[:, None])
        is_last = is_last.to(torch.float32)
        episodes["reward"] = is_last * rewards[:, None]
        episodes["terminal"] = is_last
        episodes["grasp"] = is_last

        stats = {
            "success": rewards * valid_scene,
            "explore_env": explore_env,
            "valid_scene": valid_scene,
            "episode_len": n_valid,
            # robot-obstacle/object contact during the episode (feeds the
            # collision-aware demo filters and the collide_frac log,
            # reference: env/panda_scene.py:1078-1095)
            "collided": states.collided_before,
        }
        return episodes, valid, rewards, stats

    def _step(self, agent_state, ctx, t, states, obs, done, step_draws, generator=None):
        """One step of the rollout from the carry (states, obs, done):
        the DAgger, DART and expert masks, the action, one batched env
        step, finished envs frozen -> (states, obs, done after the step,
        the step's transition, keep). `ctx` holds the rollout's per-env
        explore_env, expert_init_steps and plan_len, and its noise_scale;
        `step_draws` is `_step_draws`' tuple."""
        cfg, env, dev = self.cfg, self.env, self.device
        n = done.shape[0]
        explore_env, plan_len = ctx["explore_env"], ctx["plan_len"]
        noise_u, dagger_u, dart_u, perturb_a, env_draws = step_draws
        t_f = float(t)
        # the reference caps DAgger at expert_traj_length-8 with fixed
        # 20-step OMG plans; servo plan lengths are distance-based, so
        # the cap is relative to the actual plan
        dagger = (cfg.dagger & explore_env & (t_f > cfg.dagger_min_step)
                  & (t_f < torch.clamp(plan_len + 2.0, max=cfg.dagger_max_step))
                  & (dagger_u < cfg.dagger_ratio))
        if cfg.dagger and env.p.use_planner:
            # the planner expert: a DAgger relabel replans from the policy's
            # current state (reference: core/train_online.py:246-251)
            replan = dagger & ~done
            if bool(replan.any()):
                states = _where(replan, env.replan(states), states)
        expert_a = env.expert_action(states)
        remain = torch.clamp(plan_len - t_f, min=1.0)
        policy_a, _ = self.select_action(agent_state, self._policy_input(obs), remain)
        policy_a = policy_a + exploration_noise(
            noise_u, self.agent_cfg.action_noise * ctx["noise_scale"],
            self.agent_cfg.noise_type)
        dart = (cfg.dart & ~explore_env & (t_f > cfg.dart_min_step)
                & (t_f < cfg.dart_max_step) & (dart_u < cfg.dart_ratio))
        expert_now = ~explore_env | dagger
        if cfg.expert_initial_state and cfg.policy != "BC":
            expert_now = expert_now | (t < ctx["expert_init_steps"])
        action = torch.where(expert_now[:, None], expert_a, policy_a)
        # DART perturbation (reference: env/panda_scene.py:1069-1076)
        action = torch.where(dart[:, None], perturb_a, action)

        new_states, new_obs, _, new_done, info = env.step_batched(
            states, action, generator, env_draws, requery_goal=explore_env & ~dagger)
        # expert episodes end when the plan does (+slack: the servo
        # tracks a distance heuristic, not an exact trajectory,
        # reference: core/train_online.py:286 EXTEND_MAX_STEP)
        new_done = new_done | (~explore_env & (t_f >= plan_len + 3.0))

        # freeze finished envs
        keep = ~done
        states = _where(keep, new_states, states)
        obs_next = _where(keep, new_obs, obs)
        expert_flag = torch.where(dagger, 2.0, (~explore_env).to(torch.float32))
        zeros = torch.zeros(n, device=dev)
        trans = {
            "point_state": obs.point_state,
            "action": action,
            "expert_action": expert_a,
            "reward": zeros,
            "terminal": zeros,
            "timestep": torch.full((n,), t_f, device=dev),
            "state_pose": obs.ef_pose,
            "goal": obs.goal_pose,
            "expert_flags": expert_flag,
            "perturb_flags": dart.to(torch.float32),
            "collide": info["collided"].to(torch.float32),
            "grasp": zeros,
            "target_idx": states.obj_idx.to(torch.float32),
        }
        if self.agent_cfg.use_image:
            # in the ring's bfloat16 already: the insert would round it so,
            # and the horizon's frames take half the memory
            trans["image_state"] = obs.image.to(torch.bfloat16)
        return states, obs_next, done | new_done, trans, keep

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, agent_state, generator=None, draws=None, expert=False):
        """Policy evaluation on freshly randomised scenes; with `expert`,
        the expert's (the reference's --expert A/B baseline,
        reference: core/train_test_offline.py:208-223)."""
        draws = shard_leading_axis(self.mesh, draws)
        states, obs = self.env.reset(self.num_envs, generator,
                                     None if draws is None else draws["reset"])
        return self._eval_from(agent_state, states, obs, generator, draws, expert)

    @torch.no_grad()
    def evaluate_scenes(self, agent_state, scenes, generator=None, expert=False):
        """Policy (or, with `expert`, expert) evaluation on a fixed scene
        set of num_envs scenes (envs/scenes.py), the reproducible protocol
        (reference: core/train_test_offline.py:176-256); under a mesh this
        rank's share of them."""
        states, obs = self.env.reset_scene(shard_leading_axis(self.mesh, scenes), generator)
        return self._eval_from(agent_state, states, obs, generator, expert=expert)

    def _eval_from(self, agent_state, states, obs, generator=None, draws=None, expert=False):
        cfg, env, dev = self.cfg, self.env, self.device
        n = self.num_envs
        valid_scene = states.valid_scene
        if cfg.eval_time_mode == "steps":
            # deployment convention: episode step budget countdown
            plan_len = torch.full((n,), float(cfg.max_steps), device=dev)
        else:
            plan_len = env.expert_steps(states)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        for t in range(cfg.rollout_horizon):
            if expert:
                action = env.expert_action(states)
            else:
                remain = torch.clamp(plan_len - float(t), min=1.0)
                action, _ = self.select_action(agent_state, self._policy_input(obs), remain)
            env_draws = None if draws is None else draws["steps"][t]["env"]
            new_states, new_obs, _, new_done, _ = env.step_batched(states, action, generator,
                                                                   env_draws)
            keep = ~done
            states = _where(keep, new_states, states)
            obs = _where(keep, new_obs, obs)
            done = done | new_done
        states, rewards = env.retract_batched(states)
        return {
            "success": rewards,
            "valid_scene": valid_scene,
            "obj_idx": states.obj_idx,
            # robot-obstacle/object contact during the episode (the
            # reference logs collision alongside success,
            # reference: core/train_test_offline.py:258-302)
            "collided": states.collided_before,
        }

