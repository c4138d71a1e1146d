"""The online training loop (counterpart of gaddpg_tpu/train/loop.py).

Orchestrates what the reference spreads over 5 Ray actor types
(reference: core/train_online.py:357-574, core/trainer.py): rollout ->
replay insert on the device -> K agent updates, with explore/noise
schedules keyed on the update step. One process a card (or, under a
data-parallel mesh, a process a rank); the host work is the schedule
arithmetic, the ring's cursors and logging.
"""

import time

import torch

from gaddpg_tpu_torch import replay
from gaddpg_tpu_torch.agents.bc import make_bc_update
from gaddpg_tpu_torch.agents.ddpg import make_ddpg_update
from gaddpg_tpu_torch.agents.state import (
    create_agent_state, set_state_counts, state_counts, state_tensors,
)
from gaddpg_tpu_torch.envs.assets import library_from_index
from gaddpg_tpu_torch.envs.grasp_env import PandaGraspEnv
from gaddpg_tpu_torch.envs.scenes import scene_slice
from gaddpg_tpu_torch.parallel.mesh import (
    all_gather_rows, broadcast_, local_slice, replicate, validate_dp_divisibility,
)
from gaddpg_tpu_torch.train.checkpoints import load_agent, save_agent
from gaddpg_tpu_torch.train.config import TrainConfig
from gaddpg_tpu_torch.train.metrics import MetricLogger, ObjectPerformance
from gaddpg_tpu_torch.train.rollout import RolloutWorker
from gaddpg_tpu_torch.train.schedules import explore_schedule, noise_schedule
from gaddpg_tpu_torch.utils.precision import resolve_device


class Trainer:
    def __init__(self, cfg: TrainConfig, lib=None, env=None, mesh=None, device="cuda"):
        """Everything on `device` (the card unless device="cpu"; raises
        without one): the env, the agent state (initialised from
        cfg.seed), the replay ring(s) and a generator seeded with
        cfg.seed for the rollout, sampling and update draws.

        `mesh` (a `parallel.mesh.Mesh`; every rank builds its Trainer
        alike, on the mesh's device) shards the whole train iteration
        data-parallel, as the JAX package's mesh does: each rank runs
        num_envs / n envs, holds size / n slots of each ring's point
        states and takes batch_size / n rows of every update, while the
        agent state is replicated (built from cfg.seed on every rank and
        checked once against rank 0's). Rank 0 alone logs and writes
        checkpoints. In image mode the ring's frames shard as its point
        states do and the ResNet-18s' statistics are the global batch's."""
        validate_dp_divisibility(mesh, num_envs=cfg.num_envs, batch_size=cfg.batch_size,
                                 buffer_size=cfg.buffer_size)
        if mesh is not None:
            if cfg.onpolicy and cfg.online_buffer_size:
                validate_dp_divisibility(mesh, online_buffer_size=cfg.online_buffer_size,
                                         online_rows=int(cfg.batch_size
                                                         * cfg.online_buffer_ratio))
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lib = lib if lib is not None else library_from_index(cfg.index_file,
                                                                  cfg.index_split)
        self.env = env if env is not None else PandaGraspEnv(cfg.env, self.lib, self.device,
                                                             mesh=mesh)
        self.worker = RolloutWorker(self.env, cfg.agent, cfg, mesh=mesh, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        num_pts = cfg.env.uniform_num_pts + 6
        self.agent_state = create_agent_state(
            cfg.agent, npoints=num_pts, generator=torch.Generator().manual_seed(cfg.seed),
            device=self.device)
        replicate(mesh, state_tensors(self.agent_state), check=True)
        self.update = (make_bc_update if cfg.policy == "BC"
                       else make_ddpg_update)(cfg.agent, self.device, mesh=mesh)

        # image mode: the ring stores the RGBDM frames too (in bfloat16)
        cam = self.env.p.camera
        img_shape = (5, cam.height, cam.width) if cfg.agent.use_image else None
        self.buffer = replay.create_buffer(cfg.buffer_size, num_points=num_pts,
                                           image_shape=img_shape, device=self.device,
                                           mesh=mesh)
        self.online_buffer = None
        if cfg.onpolicy and cfg.online_buffer_size:
            self.online_buffer = replay.create_buffer(cfg.online_buffer_size,
                                                      num_points=num_pts, image_shape=img_shape,
                                                      device=self.device, mesh=mesh)
        self.metrics = MetricLogger(cfg.output_dir) if self.is_lead else None
        self.obj_perf = ObjectPerformance(self.lib.names)

    @property
    def is_lead(self) -> bool:
        """Whether this process logs and writes checkpoints (rank 0)."""
        return self.mesh is None or self.mesh.is_lead

    def load_pretrained(self, output_dir: str) -> bool:
        """Resume the agent from `output_dir`'s latest snapshot; under a
        mesh rank 0 reads it and broadcasts it. False without a snapshot."""
        restored = load_agent(self.agent_state, output_dir) if self.is_lead else None
        head = torch.tensor([restored is not None, *state_counts(restored or self.agent_state)],
                            dtype=torch.int64)
        broadcast_(self.mesh, [head])
        if not int(head[0]):
            return False
        if restored is not None:
            self.agent_state = restored
        broadcast_(self.mesh, state_tensors(self.agent_state))
        set_state_counts(self.agent_state, head[1:].tolist())
        return True

    @property
    def update_step(self) -> int:
        return int(self.agent_state.update_step)

    # ------------------------------------------------------------------
    def collect(self, draws=None):
        """One rollout wave across all envs; insert episodes into replay.
        `draws`: the rollout's draws as tensors (`RolloutWorker.rollout`);
        None draws from the trainer's generator."""
        cfg = self.cfg
        explore = explore_schedule(self.update_step, cfg)
        noise = noise_schedule(self.update_step, cfg)
        episodes, valid, rewards, stats = self.worker.rollout(
            self.agent_state, explore, noise, self.generator, draws)
        # BC keeps only successful expert demos
        # (reference: core/replay_memory.py:214-215)
        if not cfg.rl:
            keep = (rewards > 0.5) | stats["explore_env"]
            if cfg.dagger_success_filter:
                # success-filtered DAgger: explore waves only aggregate
                # when the relabelled episode succeeds
                keep = rewards > 0.5
            if cfg.demo_collision_filter:
                keep = keep & ~stats["collided"]
            valid = valid & keep[:, None]
        gamma = cfg.agent.gamma
        if self.online_buffer is not None:
            explore_env = stats["explore_env"][:, None]
            replay.add_episodes(self.buffer, episodes, valid & ~explore_env, gamma)
            replay.add_episodes(self.online_buffer, episodes, valid & explore_env, gamma)
        else:
            replay.add_episodes(self.buffer, episodes, valid, gamma)

        # every rank's envs in rank order (this rank's without a mesh)
        cols = all_gather_rows(self.mesh, torch.stack(
            [episodes["target_idx"][:, 0], rewards, stats["valid_scene"].float(),
             stats["success"], stats["collided"].float()], dim=1))
        target_idx, rewards, valid_scene, success, collided = cols.T
        valid_scene, collided = valid_scene > 0.5, collided > 0.5
        self.obj_perf.update(target_idx.cpu().numpy(), rewards.cpu().numpy(),
                             valid_scene.cpu().numpy())
        n_scenes = max(float(valid_scene.sum()), 1.0)
        return {
            "rollout_success": float(success.sum()) / n_scenes,
            "explore_frac": float(explore),
            "valid_scene_frac": float(valid_scene.float().mean()),
            "collide_frac": float((collided & valid_scene).sum()) / n_scenes,
            "buffer_idx": int(self.buffer.cur_idx),
            "env_steps": int(self.buffer.total_env_step),
        }

    # ------------------------------------------------------------------
    def train_iter(self, draws=None):
        """K agent updates from the replay (reference: core/trainer.py:202-293).

        With an on-policy buffer, each update batch mixes
        int(batch_size * online_buffer_ratio) of the agent's own rollouts
        into the expert batch (reference: core/trainer.py:214-225).
        `draws`: one dict per update with the sampled indices "idx" (and
        "online_idx" when mixing) and the DDPG target-smoothing draws
        "noise" (B, 6); None draws from the trainer's generator. Under a
        mesh the draws are the global batch's and each rank updates on its
        rows of it."""
        cfg = self.cfg
        if replay.upper_idx(self.buffer) < cfg.batch_size:
            return {}
        n_on = 0
        if self.online_buffer is not None and cfg.online_buffer_ratio > 0:
            n_on = int(cfg.batch_size * cfg.online_buffer_ratio)
            if replay.upper_idx(self.online_buffer) < n_on:
                n_on = 0
        ep_len = min(cfg.max_steps, 8)
        last = {}
        for i in range(cfg.updates_per_iter):
            d = {} if draws is None else draws[i]
            batch = replay.sample(self.buffer, cfg.batch_size, episode_max_len=ep_len,
                                  onpolicy_goal=cfg.self_supervision,
                                  generator=self.generator, idx=d.get("idx"))
            if n_on:
                on = replay.sample(self.online_buffer, n_on, episode_max_len=ep_len,
                                   onpolicy_goal=cfg.self_supervision,
                                   generator=self.generator, idx=d.get("online_idx"))
                batch = {k: torch.cat([batch[k], on[k]], dim=0) for k in batch}
            if cfg.policy == "BC":
                last = self.update(self.agent_state, batch)
            else:
                noise = self._local_noise(d.get("noise"), cfg.batch_size, n_on)
                last = self.update(self.agent_state, batch, self.generator,
                                   None if noise is None else noise.to(self.device))
        return {k: float(v) for k, v in last.items()}

    def _local_noise(self, noise, n_main: int, n_on: int):
        """Under a mesh, this rank's rows of the global batch's smoothing
        draws (given, or drawn here as the update would draw them): its
        share of the ring's rows, then its share of the online ring's, as
        its batch is laid out. As given without a mesh."""
        if self.mesh is None:
            return noise
        if noise is None:
            draw = torch.rand if self.cfg.agent.noise_type == "uniform" else torch.randn
            noise = draw((n_main + n_on, 6), generator=self.generator, device=self.device)
        noise = noise.to(self.device)
        main, on = noise[:n_main], noise[n_main:]
        return torch.cat([main[local_slice(self.mesh, n_main)],
                          on[local_slice(self.mesh, n_on)]], dim=0)

    # ------------------------------------------------------------------
    def run(self, max_iters=None, log_every=None):
        """Full online loop (reference: core/train_online.py:531-574).
        Scalars go to metrics.jsonl every `log_every` iterations (default
        cfg.log_interval) and at the last of `max_iters`."""
        cfg = self.cfg
        log_every = log_every or cfg.log_interval
        it = 0
        while self.update_step < cfg.max_epoch:
            it += 1
            last = bool(max_iters) and it >= max_iters
            t0 = time.time()
            roll_stats = self.collect()
            t_roll = time.time() - t0
            t0 = time.time()
            train_stats = self.train_iter()
            t_train = time.time() - t0

            if self.is_lead and (it % log_every == 0 or last):
                scalars = dict(roll_stats)
                scalars.update(train_stats)
                scalars.update(rollout_time=t_roll, train_time=t_train,
                               update_step=self.update_step)
                self.metrics.log(self.update_step, scalars)
            if (self.is_lead and self.update_step
                    and self.update_step % cfg.save_interval == 0):
                save_agent(self.agent_state, cfg.output_dir)
            if last:
                break
        if self.is_lead:
            save_agent(self.agent_state, cfg.output_dir)
        return self.obj_perf

    # ------------------------------------------------------------------
    def evaluate(self, episodes: int = 1, scenes=None, expert: bool = False):
        """Policy (or, with `expert`, expert-baseline) evaluation waves ->
        (success rate over valid scenes, per-object table). With `scenes`
        (a scene set from envs/scenes.py) the protocol is deterministic:
        wave w evaluates scenes [w * num_envs, ...), wrapping around, as the
        reference's fixed scene_{k} loop does; else freshly randomised
        scenes. Under a mesh each rank evaluates its share of every wave,
        and the counts are every rank's."""
        total, ok = 0, 0
        perf = ObjectPerformance(self.lib.names)
        n = self.cfg.num_envs
        for w in range(episodes):
            if scenes is not None:
                out = self.worker.evaluate_scenes(self.agent_state,
                                                  scene_slice(scenes, w * n, n),
                                                  self.generator, expert=expert)
            else:
                out = self.worker.evaluate(self.agent_state, self.generator, expert=expert)
            cols = all_gather_rows(self.mesh, torch.stack(
                [out["valid_scene"].float(), out["success"], out["obj_idx"].float()], dim=1))
            v, r, obj_idx = cols.T.cpu().numpy()
            v = v > 0.5
            perf.update(obj_idx, r, v)
            total += int(v.sum())
            ok += int((r[v > 0] > 0.5).sum())
        return ok / max(total, 1), perf

