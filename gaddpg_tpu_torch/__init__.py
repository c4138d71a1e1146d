"""PyTorch + CUDA port of `gaddpg_tpu` for NVIDIA Hopper (H100).

The layout mirrors the JAX package, so each module's counterpart sits at
the same relative path. This package imports torch, numpy and scipy
only, never JAX or anything of `gaddpg_tpu`.

What is ported:
- the policy-serving path: a (B, 4, 1030) point state -> PointNet++
  encoder -> Gaussian policy head (`agents.ddpg.make_select_action`,
  `deploy.runner.PolicyRunner`);
- the learner: the train-mode encoder (batch-statistics BatchNorm), the
  twin-Q critic, the losses, the optimizers and the DDPG and BC updates
  (`agents.ddpg.make_ddpg_update`, `agents.bc.make_bc_update`);
- the batched env: reset, DLS IK, contact physics, wrist-camera point
  state, retract, the CHOMP planner and goal-servo experts and dynamic
  clutter (`envs.grasp_env.PandaGraspEnv`);
- the online train loop: the replay ring on the device
  (`replay.create_buffer`, `add_episodes`, `sample`, the reference's
  `.npz` format), the batched rollout (`train.RolloutWorker`) and
  `train.Trainer` (collect -> insert -> sample -> update);
- the object pipeline (`data/`: procedural meshes, OBJ and grasp files,
  the mesh-to-asset pipeline on the native host library, grasp labels
  from the contact physics on the CPU; `envs.assets.library_from_index`
  for every object index) and the grasp-pose trainer (`GoalFeature`,
  `data.grasp_dataset`, `cli.train_goal`);
- image mode: RGBDM observations with domain randomisation
  (`render.camera.render_rgbdm`) and the ResNet-18 agent
  (`models.resnet`, `AgentConfig(use_image=True)`);
- the CLIs (`cli.train_online`, `cli.train_test_offline`,
  `cli.show_metrics`) and the visual utilities (`utils.video`,
  `utils.recording`);
- data-parallel training (`parallel`: one process a rank started by
  `parallel.launch`, `train.Trainer(mesh=)` with the env batch, the
  replay ring's capacity and the update's batch sharded, every
  BatchNorm's statistics over the global batch; `parallel.dryrun`).
Their seven kernels (furthest point sampling, ball query, the two eval
set-abstraction kernels, the two train-mode stats kernels and the
physics contact scan) are hand-written CUDA C++ for sm_90a under
`ops/csrc/`, built with nvcc at first use.

Entry points default to `device="cuda"` and raise when no card is
present; pass `device="cpu"` to run the plain PyTorch versions of the
kernels instead.
"""
