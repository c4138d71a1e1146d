#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`gaddpg_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--scale2-seeds A-B [--plain-on-card K5,K6]]
                          [--k5-scale EPS,...] [--loop] [--planner] [--clutter] [--proc]
                          [--image] [--cli] [--dp]

Phases, each of which must pass:
  1. build the CUDA kernels of K1 FPS, K2 ball query, K3 eval SA
     gather+MLP, K4 eval group-all SA and the train SA levels K5 and K6
     from gaddpg_tpu_torch/ops/csrc;
  2. hold each kernel against its plain PyTorch version on the card,
     batches 8 and 256, at the widths of model_scale 1 and 2 (SA2 259 ->
     256 -> 256 -> 512 and SA3 515 -> 512 -> 512 -> 1024 at scale 2): K1-K4
     at the serving shapes (indices exactly equal, floats within rtol =
     atol = 1e-4: fp32, different summation order); K1 also on tie-heavy
     clouds (a cloud of 8 points repeated, an integer grid; B = 1, 256,
     1024, N = 1024, 1031, 32, 33) and synthetic clouds at B = 1, 256,
     1024, its SA2 call on each cloud's SA1 centres, and (phase 9) on the
     env's clouds; K2 the same way (SA1 and SA2 at B = 1, 256, 1024 on
     synthetic and, in phase 9, the env's clouds), and on clouds that
     stress its walk (N = 1, 31, 33, 1030 and 1100, so a partial chunk and
     more than 32 chunks; 13 centres; 13 slots; far centres whose nearest
     point is repeated; an integer grid; r = 0; all drawn from a generator
     of K2_SEED's), indices exactly equal and two launches bit-identical;
     FPS and ball query with an all-true `valid=` mask at B=8 (the plain
     version on the card, no launch) equal to K1's and K2's indices;
     K5/K6 (`sa_train_fused`,
     `groupall_train_fused`) at the learner's shapes (policy SA1, value
     SA1, SA2, SA3): pooled output and batch statistics within 1e-4,
     the gradient of sum(pooled^2) through the wrapper within 1e-3 of
     each leaf's largest (the Dense biases,
     whose exact gradient is 0 under a batch-stat BatchNorm, within 1e-3
     of the call's largest gradient of 0 on both sides), and two calls
     giving bit-identical pooled outputs and statistics; then K3 and K5
     at B=8, SA1 and SA2,
     on groups that stress their compaction to distinct slots (every slot
     computed, every slot padded, the ball query's K > N padding,
     out-of-range indices, repeats that differ from slot 0) against the
     plain versions on the zero-row form of the same inputs, at the same
     bounds (K5's gradients where the indices lie in [0, N)), two calls
     bit-identical; and K4 within 1e-4 at B = 1, 3, 256 and 1024 (partial
     and ragged 128-row tiles) on both branches of its width test (the
     fused wgmma kernel at scale 1, K6's layer engine at scale 2), on a
     batch whose last layer's pre-activations are all negative, two
     calls bit-identical, and the weight-pack kernel of K4 and K6 equal
     bit for bit to its plain version (`layer_weight_pack_reference`);
  3. drive the serving path, `make_select_action` on a full-width agent
     state from a seeded generator, at batch 1, 8 and 1024, with the
     launch counters set to 0 just before and read just after (each call
     must launch K1 2x, K2 2x, K3 2x, K4 1x), and hold its actions and
     aux predictions against the same state run on the CPU (1e-3, after
     the FPS / ball-query indices, which must be equal);
  4. drive `PolicyRunner` on synthetic depth frames through APPROACH ->
     RETRACT -> DONE;
  5. time each serving kernel and its plain version at the serving shapes
     (CUDA events, median; K2 also at B = 8 and 256, on clouds of its own
     seed), with K3's distinct-row share and its bound (distinct rows at
     165 TFLOP/s), select_action per batch (host clock) and its
     device busy time and top device activities (torch.profiler).
     Phase 4 reports the runner's per-request latency;
  6. drive the learner: `make_ddpg_update` and `make_bc_update` on a
     full-width agent state at batch 256 x 1030 points (bench.py's
     batch), one warm-up and three timed updates each, the counters set
     to 0 before and read after every update (a DDPG update runs five
     train-mode encoder forwards: K1 10x, K2 10x, K5 10x, K6 5x and no
     K4: K5 and K6 pool themselves; a BC update a fifth of that),
     every metric finite; two DDPG updates at batch 8 on the card and on
     the CPU from the same state (with carried Adam moments; the second
     from the CPU's state after the first), a batch whose actor term is
     live, and the same smoothing draws: metrics of both updates within
     1e-3, and after the first the running
     statistics, every parameter's and target's move (the bounds of
     tests/test_torch_learner.py) and the update step; update times
     (host clock), device busy
     time, idle share and where the device time goes (torch.profiler; no
     K4 kernel may appear), peak memory, and K5/K6 per level against
     their plain versions and bounds, with K5's distinct-row share, on
     synthetic clouds and on bench.py's learner batch, and K3-K6 at the
     scale 2 widths; then `AgentConfig(compute_dtype="bfloat16")` (the
     encoders' FC Dense layers in bfloat16, everything else float32):
     select_action at B = 1 and 1024 and DDPG and BC updates at 256 x 1030
     (launches as in float32, times, finite metrics, float32 parameters),
     and a B=8 DDPG update card vs CPU from a common state, each output
     within a tenth of the CPU's own bfloat16-against-float32 gap or 4
     times the CPU update's spread over 3 perturbations of the point
     states by 2^-20 relative, the size of K5's and K6's 3xTF32 departure
     (tests/test_torch_bf16.py's rule, whose one-ulp nudges leave the
     CPU's bfloat16 update unchanged);
  7. hold K7 (the contact scan) against its plain version on the card
     over 60 substeps at batch 8 and over 75, 150 and 200 substeps at
     batch 64 and 1024, on contact-rich states (objects
     at the closing gripper and on the table, as
     tests/test_pallas_physics.py builds them, tiled with seeded jitter)
     and on states from a live env rollout with the fingers closing:
     pos and quat within 2e-5, linvel 2e-4, angvel 2e-3, fingers 2e-5 (the
     JAX suite's bounds, tests/test_pallas_physics.py:59-66), the
     gripper-contact flag equal, and two launches bit-identical. A grasp
     at the edge of slipping is chaotic: nudging its object position by
     one ulp moves the plain version itself past those bounds (up to
     2e-4 m and 0.19 m/s over 60 substeps). Such envs, at most 3% of a
     batch, are counted, and the kernel's departure there, in units of
     the bounds, must stay within 4 times the largest departure of the
     plain version itself over 8 one-ulp nudges. Beyond 60 substeps the
     nudges move the whole object state, 32 of them measure each env's
     spread, every env off the bounds must be chaotic, their count may
     reach one nudge's own count on the batch, and their departures,
     largest first, must stay within 4 times the departures one nudge
     gives the plain version on the same batch, rank by rank
     (check_contact_scan says why). A B=64 launch must give the first
     64 envs of the B=1024 launch bit for bit;
  8. drive the env path, `PandaGraspEnv(EnvParams(),
     library_from_index("ycb", "train"))` at batch 1024 (bench.py's env
     half: the CHOMP planner expert): `reset` from a seeded generator (a
     plan per reset try), 20 steps of the planner expert (plan_step 20
     after them), `retract_batched`, with the counters set to 0 before and read
     after each call (K7 2x in reset, one 200-substep settle per try; 1x
     per step; 11x in retract, the close and 10 lift steps); every value
     finite, every object below z = 1.0 unless the gripper carries it
     (in contact, its centre within 0.15 m of the hand: the expert can
     carry a light object up before the retract, as the JAX package does
     on the same scene), the valid-scene count and the
     lift rate over valid scenes; then time `step_batched` (host clock,
     median of 7 after a warm-up, bench.py's constant action), its device
     busy time, idle share and top device activities (torch.profiler),
     `reset` and `retract_batched`, and K7 against its plain version and
     its bound (CUDA events) at n = 75 (B = 1024 and 64) and n = 200 (K7's
     live states come from a goal-servo rollout); `plan_to_goal` on the
     card against the CPU at B = 8 and 256 on the reset's planner inputs
     (PLAN_TOL_CARD's rule: each plan within 1e-3 rad of the CPU's with
     `ok` equal, or within 4 times the CPU's own spread under one-ulp
     nudges of all its inputs, or on another near-tied IK branch with the
     reached hand pose within 1 mm; at most 3% of the batch left, each
     reaching its pose within 1 mm); `replan`'s
     time; and examples/minimal_rollout.py's contract: EnvParams() on
     box_asset(0.05, 0.05, 0.14, mass=0.2), seeds 0-7 from CPU generators,
     the card's lift count within one of the CPU's on the same scenes (the
     JAX package itself lifts 6 of 8 with the planner,
     tests/test_torch_env_contract.py). --planner runs this phase alone;
  9. run 8 scenes of the goal-servo env through `reset_scene`, 3 `step_batched` calls
     (each from the CPU's state carried over) and `retract_batched` on the
     card and on the CPU with the same random draws (after it, phases 5
     and 6 time K3 at B=1024 and K5 at B=256 once more, on the
     wrist-camera point states of phase 8 after its expert steps, and on
     the worst case of those SA2 inputs, every slot computed): the object and
     fingers within the phase-7 bounds, the arm within two quanta of its
     servo (2.4e-4 rad; tests/test_torch_env.py says why), the grasp goal
     within 1e-4, done and collided equal, the target-point count within
     1% + 2 and at most 10% of the sampled points without a point of the
     other device's reservoir within 1e-4 (the servo quantum moves the
     camera, and a pixel-edge difference of the z-buffer shifts the
     reservoir, tests/test_torch_env.py), and equal lift outcomes. An env
     whose object is off the bounds must be chaotic as in phase 7: the
     CPU path, with its object position nudged by one ulp, moves at least
     a quarter as far; such an env's view is not compared;
 10. the model_scale 2 agent card vs CPU: `select_action` at B=8 (the
     launches of one call as at scale 1, K4 on its layer engine) within
     1e-3, and one B=8 DDPG update from a common state on each of the
     batches of seeds 0 and 27 (SCALE2_SEEDS), within phase 6's bounds, each logged
     beside the plain version's one-ulp spread. A group past its bound
     passes only as the reference's own rounding tie: of 16 CPU updates
     on one-ulp nudges of the batch's point states, one crosses the same
     bound, and the card's count of moves off is within 1% of the count
     of one that crosses (seed 27's batch crosses so). Those CPU
     updates run on CROSSING_THREADS threads. With
     --scale2-seeds A-B the build and this check alone run, on the batches
     of seeds A to B; --plain-on-card K5,K6 runs those kernels' plain
     versions on the card there; --k5-scale EPS,... runs it with K5's
     pooled output scaled by (1 + EPS), the check's sensitivity;
 11. the online train loop: `Trainer(load_config(overrides={"num_envs":
     1024, ...}, policy="DDPG"), lib=library_from_index("ycb", "train"))`
     at TrainConfig's defaults, its EnvParams() the CHOMP planner
     (batch 256 x 1030 points, 4 updates, a 100,000-transition ring on the
     card): one `collect` and one `train_iter`, the counters set to 0
     before each and read after (every kernel launched, each as many times
     as the horizon's select_action calls, the env calls and the four
     updates give), buffer_idx > 0, update_step 4, every metric finite;
     the collect's split into reset, steps, retract and insert, env
     steps/s, train_iter ms (of a second, warm iteration), launches per
     iteration, replay bytes, and one step, one replan and one update of
     it under torch.profiler for the device's busy and idle share of those
     parts; then a B=8 Trainer at the
     dryrun's env sizes on the card and on the CPU from the same draws: flags, masks, episode_map, cursors and
     sampled indices equal, each env step within phase 9's rule from the
     card's own input state, and the train_iter from a common ring and
     state within phase 6's update rule; then the same B=8 collect with
     the planner and the DAgger replan, each reset try's plans and each
     DAgger replan held to phase 8's planner rule against the CPU's
     `replan` from the same state. --loop runs this phase alone;
 12. dynamic clutter: one `Trainer(load_config("experiments/cfgs/
     td3_clutter.yaml"), lib=library_from_index("ycb", "train"))`
     iteration at its own sizes (256 envs of EnvParams(num_clutter=2,
     use_planner=True), DAgger, 20 DDPG updates of 128 + 128 on-policy
     rows x 1030 points, rings of 500,000 and 100,000): one iteration,
     counted (K1-K4 at every step, K7 never: physics/multi.py steps the
     clutter; K1, K2, K5, K6 in the updates) and timed, split into reset
     (its planner), steps, DAgger replans, retract, insert and train_iter,
     env steps/s, and (with --clutter alone; the full run leaves it out,
     for time) one step and update profiled for the device's busy and
     idle share; then the clutter path at B=8 on the
     card and on the CPU (`clutter_card_vs_cpu` says by which rules: phase
     9's with the clutter bodies, near-tied grasp goals, phase 8's planner
     rule with the verdict's own flips) and generate_scenes ->
     Trainer.evaluate(scenes=, expert=True) with the same valid flags; and
     physics/multi.py with its clutter parked far away against K7 at
     B=256 over 60 substeps within phase 7's bounds. --clutter runs this
     phase alone;
 13. a procedural library and the GoalFeature trainer:
     `library_from_index("proc_shapenet:4")` built on the host's CPU (the
     mesh pipeline, the physics-verified grasps; seconds, grasp and sphere
     counts, whether native/libmesh_tools.so was built) in a child
     process that a full run starts before phase 2 (`LibraryBuild`); one TrainConfig()
     iteration on it at 1024 envs, as phase 11 runs it ("[proc]" lines:
     launches, the counted iteration's split); K7 at B=64 over 75
     substeps on that reset's mesh scenes (padding spheres parked at
     z = 1e3) under phase 7's rule, K1 and K2 on its clouds as phase 9
     checks them, K3 and K4 within phase 2's bounds; then
     `cli.train_goal.main` at its defaults (batch 32, 512-point clouds,
     64 x 64 camera) for 20 steps, counted (per update K1 2x, K2 2x, K5
     2x, K6 1x), losses finite; the generator at B=64 card vs CPU on the
     same draws (rule (c)); K1, K2, K5 and K6 against their plain
     versions at the GoalFeature's shapes (6 input columns, 128 centres,
     zero rows), K5 and K6 timed; one GoalFeature update card vs CPU
     from a common state under phase 6's rule. --proc runs this phase
     alone;
 14. image mode: one `Trainer(load_config(overrides={"use_image": True,
     "domain_rand": True, "num_envs": 1024}))` iteration on the YCB
     proxies after a warm-up one, counted and timed (112 x 112 RGBDM, two
     ResNet-18 encoders, 4 DDPG updates at batch 256, a 100,000-transition
     ring of bfloat16 frames, the CHOMP planner; K1-K6 launch 0 times, K7
     as in phase 11), the collect's split and env steps/s; a DDPG and a
     BC update at batch 256 and select_action at B = 1 and 1024 timed with
     their device busy and idle share; the image env at B=8 card vs CPU
     (2 reset tries, 5 planner-expert steps and the retract under phase
     9's rule, the reset plans under phase 8's, every view by
     `image_rule`: the card's and the CPU's render of the card's state
     may differ on at most IMAGE_EDGE_SHARE of a view's pixels);
     ImageFeature card vs CPU at B=8 on the Trainer's weights within
     IMAGE_FEATURE_TOL; one image DDPG and one BC update at B=8 from a
     common state under phase 6's rule; export_torch_state -> .npz ->
     pretrained_resnet bit for bit; utils.video.record_episode at B=1.
     --image runs this phase alone;
 15. the CLIs as child processes, each of which must exit 0:
     `python -m gaddpg_tpu_torch.cli.train_online --config_file
     experiments/cfgs/td3_critic_aux_policy_aux.yaml --policy DDPG
     --max_iters 1` (256 envs, 20 updates at batch 128, a 500,000 ring;
     the child counts the kernels' launches), then `train_test_offline
     --test --pretrained` on its checkpoint for 256 episodes with the
     policy and with --expert (at once), then `show_metrics` on the run.
     --cli runs this phase alone (--image --cli both);
 16. data-parallel training (`gaddpg_tpu_torch.parallel`): 2 ranks share
     the card over gloo, their collectives staged through the host (NCCL
     refuses two ranks on one device), started by `parallel.launch`
     with a timeout. On the ranks: K5 and K6 split at the reduction
     (`mesh=`) at the learner's shapes (policy SA1, value SA1, SA2, SA3
     at 256 x 1030, scale 1 and 2), each rank on half the rows, against
     the whole-batch kernel call here and against the plain version with
     the same reduction on the card (phase 2's bounds, gradients
     included, two calls bit-identical); the sharded DDPG and BC updates
     at 256 x 1030 from a state with carried Adam moments, and the same
     on 1 rank over NCCL, against the update without a mesh on the card
     (phase 6's update rule; every rank's state bit-identical; times and
     the collectives' share); one TrainConfig() iteration at 1024 envs
     (512 a rank, EnvParams() with the planner, 4 updates), counted
     (each rank's launches equal to phase 11's per-iteration counts) and
     timed (the rank's first, cold iteration: the collect's split, env
     steps/s); image mode on the ranks: ImageFeature's train forward at
     B=256, 112 x 112 (both ResNet-18s, their 20 BatchNorms each
     reduced across the ranks) against the whole-batch forward here by
     IMAGE_FEATURE_TOL["train"] (outputs and every statistic) and phase
     2's gradient rule, two split forwards bit-identical, timed beside
     the whole batch's; the sharded image DDPG and BC updates at batch
     256 from carried Adam moments against the update without a mesh
     (phase 6's rule, every rank's state bit-identical, times and the
     collectives' share); one load_config(use_image, domain_rand)
     iteration at 1024 envs (512 a rank; the ring's frames sharded,
     fetched from their owners as bytes), counted (K7 as phase 14, K1-K6
     0), with buffer_idx > 0, update_step 4, finite metrics, the split,
     env steps/s and each rank's peak allocated memory; the fast dry-run
     tier against 1 rank on the
     card (tests/test_torch_dp_train.py's rules) and the flagship tier
     (`parallel.dryrun`; its library built on the host's CPU beside the
     earlier phases). Ranks sharing one card measure the parallel path's
     overhead, not a speedup. --dp runs this phase alone.

Prints the card's name and power limit (nvidia-smi), then one JSON line
with every kernel's numbers (launches: K1-K4 over the phase-3 calls, K5/K6
over the phase-6 updates, K7 over the phase-8 env path;
launches_per_train_iter over phase 11's collect and train_iter,
launches_per_clutter_iter over phase 12's, launches_per_goal_update over
phase 13's cli.train_goal steps, launches_per_image_iter over phase 14's
counted iteration, launches_per_dp_iter and launches_per_image_dp_iter
on each of phase 16's ranks over its counted iteration and its image
iteration; ms, plain_ms,
bound_ms: K1-K4 summed over the kernel's levels in one forward at
B=1024 on the synthetic serving clouds, K5/K6 over their levels in one policy-encoder train forward at
B=256, K7 one 75-substep launch at B=1024; dp_split_ms: K5/K6 over the
same forward split over phase 16's 2 ranks, a rank's host clock), then
as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is available or any phase fails.
"""

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, fp32
# outside the tensor cores (K1, K2, K7), and the dense fp32 products of
# K3-K6 on the tensor cores at fp32 accuracy: the 495 TFLOP/s TF32 peak
# spent three times per product (3xTF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
TENSOR_CORE_KERNELS = ("sa_gather_mlp", "mlp_maxpool", "sa_train", "groupall_train")

SA_LEVELS = (  # (name, npoint, radius, nsample) of the grouped levels
    ("SA1", 32, 0.02, 64),
    ("SA2", 32, 0.04, 128),
)
REPLACES = {
    "fps": "gaddpg_tpu/ops/pallas_kernels.py:97",
    "ball_query": "gaddpg_tpu/ops/pallas_kernels.py:166",
    "sa_gather_mlp": "gaddpg_tpu/ops/pallas_sa.py:120",
    "mlp_maxpool": "gaddpg_tpu/ops/pallas_sa.py:147",
    "sa_train": "gaddpg_tpu/ops/pallas_sa_train.py:314",
    "groupall_train": "gaddpg_tpu/ops/pallas_sa_train.py:443",
    "contact_scan": "gaddpg_tpu/ops/pallas_physics.py:425",
}
SOURCES = {"sa_train": "sa_train_stats", "groupall_train": "groupall_layer"}
PER_CALL = {"fps": 2, "ball_query": 2, "sa_gather_mlp": 2, "mlp_maxpool": 1,
            "sa_train": 0, "groupall_train": 0, "contact_scan": 0}
# launches of one update: five train-mode encoder forwards (DDPG), one (BC);
# K5 and K6 pool themselves: no K4
DDPG_PER_UPDATE = {"fps": 10, "ball_query": 10, "sa_gather_mlp": 0, "mlp_maxpool": 0,
                   "sa_train": 10, "groupall_train": 5, "contact_scan": 0}
BC_PER_UPDATE = {k: v // 5 for k, v in DDPG_PER_UPDATE.items()}
TRAIN_BATCH, TRAIN_POINTS = 256, 1030  # bench.py's learner envelope
TIMED_UPDATES = 3
CHECK_BATCHES = (8, 256)      # kernels against their plain versions
K4_BATCHES = (1, 3, 256, 1024)  # K4 on one, partial and full 128-row tiles
SCALE2_FEATURE = 1024         # AgentConfig.feature_dim of a model_scale 2 agent
# the scale 2 card-vs-CPU update: one batch per seed, each from a
# generator of its own, so the batches do not depend on the phases before;
# seed 27's batch sits on a rounding tie of the reference's own update
# (ROADMAP.md Queue 3, not fault (h)), so every run holds the nudge rule.
# The full run takes seeds 0 and 27 (each ordinary seed about 18 s on a
# slow host, seed 27 with its 16 nudged CPU updates about 110 s), to
# stay within the run's time limit; --scale2-seeds 0-7,27 runs more batches
SCALE2_SEEDS = (0, 27)
# a group whose card-vs-CPU moves cross their bound passes only as the
# reference's own event: NUDGES one-ulp nudges of the batch's point states
# rerun the CPU update, one of them crosses the same group's bound, and the
# card's count is within CROSSING_MATCH of the count of one that crosses
NUDGES = 16
CROSSING_MATCH = 0.01
# the CPU updates the rule compares run on this many threads, so that their
# rounding does not follow the host's core count
CROSSING_THREADS = 8
SCALE2_SELECT_SEED = 100
# K1 on tie-heavy clouds: (B, N), N = 1024 the SA1 cloud, 32 the SA2 one
FPS_TIE_SHAPES = ((1, 1024), (256, 1024), (1024, 1024), (1024, 32), (256, 1031), (8, 33))
MAIN_BATCHES = (1, 8, 1024)   # one robot, entry(), bench.py's env count
TIME_BATCHES = (1, 1024)      # kernel timings; the JSON line sums the last
# K2 is also timed at entry()'s and the learner's batch, on clouds drawn
# from a generator of K2_SEED's, as its checks are: the other phases keep
# their draws
K2_TIME_BATCHES = (8, 256)
K2_SEED = 7
# K2 against its plain version on clouds that stress its walk: (label, N,
# centres, radius, nsample); N = 1030 and 1100 have more than 32 chunks,
# 13 centres are not a multiple of a block's 8 warps, 13 slots not of 4
K2_CASES = (("N=1", 1, 13, 0.05, 24), ("N=31", 31, 13, 0.05, 13), ("N=33", 33, 13, 0.05, 8),
            ("N=1030", 1030, 13, 0.1, 64), ("N=1100", 1100, 13, 0.05, 512))
ENV_BATCH = 1024              # bench.py's env count
# phase 12's train iteration, next to this script in the checkout
CLUTTER_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "experiments", "cfgs", "td3_clutter.yaml")
MULTI_FAST_BATCH = 256        # physics/multi.py (far clutter) against K7
# the B=8 clutter path card vs CPU: planner-expert steps, and the steps
# before which every env's plan is redone as a DAgger replan (cut from
# RL_MAX_STEP's 20, then 8, to stay within the run's time limit)
CLUTTER_CHECK_STEPS = 6
CLUTTER_REPLANS = (2, 4)
LOOP_ENVS = 1024              # the train loop's env count: bench.py's
LOOP_SEED = 11                # the B=8 loop check's generators
ENV_STEPS = 20                # RL_MAX_STEP
# phase 13: a procedural library and the GoalFeature trainer
PROC_INDEX, PROC_OBJECTS = "proc_shapenet:4", 4
PROC_K7_BATCH = 64
LIBRARY_BUILD_TIMEOUT = 600   # s, the child's library build
GOAL_STEPS = 20               # cli.train_goal steps
GOAL_BATCH = 32               # cli.train_goal's default batch
GOAL_CHECK_BATCH = 64         # the generator card vs CPU
GOAL_LR = 1e-3                # cli.train_goal's default
GOAL_LEVELS = (("SA1", 128, 0.02, 64), ("SA2", 32, 0.04, 128))  # GoalFeature's grouped levels
IMAGE_ENVS = 1024              # the image iteration's env count: bench.py's
IMAGE_CHECK_BATCH = 8         # the image env, encoder and updates card vs CPU
IMAGE_STEPS = 5               # planner-expert steps of the B=8 image env check
# record_episode's horizon: the per-env contact model at B=1 takes about
# 12 ms a substep on the card (a full 21-step episode and its retract,
# 4,950 substeps, took 58 s), so the smoke cuts the episode at 3 steps
VIDEO_STEPS = 3
# a view's pixels whose mask, depth (1e-4 m) or RGB (1e-4) differ between
# the card's and the CPU's render of the same state: projection ties at
# pixel edges (a point's pixel index is rounded from its camera
# coordinates, which the two devices sum in another order)
IMAGE_EDGE_SHARE = 0.01
# two grasp goals whose point-matching distances (the mean L1 over the 6
# finger points, expert/goals.py) from one hand pose differ by at most
# this many metres are a tie of the nearest-grasp query, which the two
# devices' rounding may break either way
GOAL_TIE_TOL = 1e-5
# ImageFeature card vs CPU, largest difference over the output's largest
# magnitude: eval mode is float32 convolutions in another order (TF32
# off); train mode normalises by batch statistics over B=8 frames
IMAGE_FEATURE_TOL = {"eval": 1e-4, "train": 1e-3}
CLI_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "experiments", "cfgs", "td3_critic_aux_policy_aux.yaml")
CLI_EPISODES = 256            # test_ycb.sh's evaluator cut to one wave of the YAML's envs
CLI_TIMEOUT = 900             # s, each CLI child
# a GoalFeature update: one train forward (the backward is the plain recompute)
GOAL_PER_UPDATE = {"fps": 2, "ball_query": 2, "sa_gather_mlp": 0, "mlp_maxpool": 0,
                   "sa_train": 2, "groupall_train": 1, "contact_scan": 0}
# K7 against its plain version: (batch, substeps); 60 is
# tests/test_pallas_physics.py's horizon, 75 a step, 150 the retract's
# close, 200 the reset's settle; 64 is TrainConfig's env count
K7_CASES = ((8, 60), (64, 75), (64, 150), (64, 200), (1024, 75), (1024, 150), (1024, 200))
K7_TIMED = ((1024, 75), (64, 75), (1024, 200))  # the first goes into the JSON line
# K7 output columns and their bounds (tests/test_pallas_physics.py:59-66)
K7_BOUNDS = {"pos": (slice(0, 3), 2e-5), "quat": (slice(3, 7), 2e-5),
             "linvel": (slice(7, 10), 2e-4), "angvel": (slice(10, 13), 2e-3),
             "fingers": (slice(13, 15), 2e-5)}
# launches of K7 per env-path call: one settle per reset try; the close
# and the lift steps of a retract
RESET_K7, STEP_K7, RETRACT_K7 = 2, 1, 1 + 10
ARM_SERVO_QUANTUM = 30.0 * 2e-3 * 2e-3  # arm_acc_limit * dt^2, rad
# a chaotic contact trajectory: how many one-ulp nudges of the plain
# version measure its spread, and the share of envs that may be chaotic
ULP_PROBES = 8
CHAOTIC_SHARE = 0.03
CHAOS_FACTOR = 4.0
# over more substeps than the JAX suite's 60, closing grasps are chaotic
# in 7-9% of the envs (one one-ulp nudge of the plain version's object
# positions moves that many past the bounds; an IEEE kernel summing in
# another order leaves 3.7% at n = 75 and 6.2% at n = 200), and a
# trajectory can be sensitive to the last bit of the velocities while
# position nudges barely move it: there a nudge moves every state float
# (position, orientation, velocities) by one ulp, ULP_PROBES_LONG nudges
# measure an env's spread (each off env must be chaotic), the share is
# held to one nudge's own share, and the departures, ranked, to
# CHAOS_FACTOR times that nudge's ranked departures on the same batch (an
# IEEE kernel leaves an env at 547 bounds whose 32 nudges reach 44: at
# that horizon a chaotic env's outcome is not bounded by its own nudges,
# but the batch's distribution of outcomes is)
K7_JAX_SUBSTEPS = 60
ULP_PROBES_LONG = 32
HELD_RADIUS = 0.15  # m, hand origin to the centre of an object in its fingers
# card vs CPU after a step: the arm may differ by a servo quantum (up to
# 2.4e-4 rad), which moves the camera by up to about 1e-4 m and flips
# pixels along the object's silhouette; shares of up to 0.041 of the
# sampled points without a match were measured on one H100
POINT_SHARE_BOUND = 0.10
# the CHOMP planner card vs CPU. The plan is the end of 50 DLS iterations
# and 30 steps of a descent preconditioned by M^-1 (entries up to 70), and
# the card rounds its transcendentals and fused products otherwise than
# the CPU at every one of them: calm envs differ by up to 9.6e-4 rad where
# the CPU's own one-ulp spread stays below 1e-6 (one H100 at 700 W), under
# the arm servo's reach in one step. Each env's plan is within
# PLAN_TOL_CARD of the CPU's with `ok` equal; or, where one-ulp nudges of
# all its planner inputs (joints, goal, target spheres) spread the CPU's
# own plan past PLAN_TOL_CARD (a hinge of the obstacle cost flips in the
# descent), within PLAN_CHAOS times that spread with `ok` equal; or the
# standoff solve landed on another near-tied IK branch (ROADMAP.md Queue 3
# not fault (b)) and the reached hand pose is within BRANCH_POSE_TOL with
# `ok` equal. The envs left (a descent the card's rounding carried further
# than the nudges reach: 3 of 1024 in one run; an `ok` that differs) may
# make up CHAOTIC_SHARE of the batch, each with its reached hand pose
# within BRANCH_POSE_TOL. The larger batch was 1024 (the env path's) until
# phase 16 joined the run; 256 keeps the run within its time limit.
PLAN_BATCHES = (8, 256)
PLAN_TOL_CARD = 1e-3
PLAN_CHAOS = CHAOS_FACTOR
BRANCH_JOINT_TOL = 1e-3  # rad: two standoff solutions this far apart are two branches
BRANCH_POSE_TOL = 1e-3   # m
# examples/minimal_rollout.py's contract (CLAUDE.md): EnvParams(), the box
# of box_asset(0.05, 0.05, 0.14, mass=0.2), seeds 0-7. With the CHOMP
# expert the JAX package itself lifts 6 of the 8 scenes its sample_scene
# draws for seeds 0-7, not 7 (tests/test_torch_env_contract.py, which holds
# the port to its outcomes). On the card the scenes of seeds 0-7 are the
# CPU's (CPU generators), but the reset's IK start may take another
# near-tied solution of the same hand pose (ROADMAP.md Queue 3 not fault
# (b)), or a scene candidate's validity may tie and the reset keep another
# try, and the plan and the grasp follow (the reset itself is held card vs
# CPU try by try in phase 11's B=8 planner loop). So the CPU plans and runs
# each episode again from the card's own reset state: the plans by
# `plan_rule`, and each seed's outcome equal to the card's, or, where it
# is not, one of ULP_PROBES CPU episodes from one-ulp nudges of that state
# (arm joints, object pose) must reach the card's
CONTRACT_SEEDS = tuple(range(8))
# compute_dtype="bfloat16" card vs CPU (tests/test_torch_bf16.py's rule,
# its perturbation the size of the card's float32 departure): each output
# within BF16_GAP_SHARE of the CPU's own bfloat16-against-float32 gap, or
# BF16_SPREAD_FACTOR times the CPU bfloat16 update's spread over
# BF16_NUDGES perturbations of the point states by a relative BF16_NUDGE.
# One-ulp nudges leave the CPU's bfloat16 update unchanged (its FC products
# round to the same bfloat16 values), while K5 and K6 on the card (3xTF32:
# each operand split within 2^-22 of its float32 value) move the SA
# features by about 2^-20 relative, enough to flip some roundings
BF16_GAP_SHARE = 0.1
BF16_SPREAD_FACTOR = 4.0
BF16_NUDGES = 3
BF16_NUDGE = 2.0 ** -20
BF16_BATCHES = (1, 1024)


def log(msg):
    print(msg, flush=True)


def kernel_wrappers():
    """{kernel: its wrapper}, each counting its launches in `.launches`."""
    from gaddpg_tpu_torch.ops import contact_scan, sa, sa_train, sampling

    return {
        "fps": sampling.furthest_point_sampling,
        "ball_query": sampling.ball_query,
        "sa_gather_mlp": sa.sa_gather_mlp,
        "mlp_maxpool": sa.mlp_maxpool,
        "sa_train": sa_train.sa_train_fused,
        "groupall_train": sa_train.groupall_train_fused,
        "contact_scan": contact_scan.contact_scan,
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cpu(batch):
    return {k: v.cpu() for k, v in batch.items()}


def _learner_modules(state):
    return {"policy": state.policy, "encoder": state.feat.encoder, "critic": state.critic,
            "value_encoder": state.feat.value_encoder,
            "critic_target": state.critic_target, "policy_target": state.policy_target}


def _move_bounds(cfg):
    """group -> (lr, threshold in lr, share of the group's elements whose
    two moves may differ by more): tests/test_torch_learner.py's bounds of
    one update with the actor term on."""
    return {"policy": (cfg.lr, 0.5, 2e-2), "encoder": (cfg.feature_lr, 0.5, 2e-2),
            "critic": (cfg.value_lr, 0.1, 1e-3), "value_encoder": (cfg.feature_lr, 0.1, 2e-3),
            "critic_target": (cfg.value_lr, 0.1, 1e-3),
            "policy_target": (cfg.lr, 2.5e-4, 1e-3)}


def _bn_fed_bias(group, name):
    """Whether `name` is a Dense bias that feeds a BatchNorm (its gradient
    is 0 up to rounding)."""
    return group.endswith("encoder") and name.endswith(".bias") and (
        ".dense." in name or name.startswith("fc."))


def move_offs(cfg, before, state, other):
    """{group: (off, total, share bound)}: how many of each group's
    elements moved from `before` differently in `state` and in `other`
    by more than the group's threshold (in lr), against the bounds
    that tests/test_torch_learner.py holds a JAX and a port update to
    with the actor term on (`_move_bounds`). BatchNorm-fed Dense
    biases are not counted (`compare_updated` holds them apart)."""
    prev, a, b = (_learner_modules(s) for s in (before, state, other))
    out = {}
    for group, (lr, threshold, share) in _move_bounds(cfg).items():
        off = total = 0
        for (name, p0), (_, p), (_, q) in zip(prev[group].named_parameters(),
                                              a[group].named_parameters(),
                                              b[group].named_parameters()):
            if _bn_fed_bias(group, name):
                continue
            moved = (p.detach().cpu() - p0).double()
            moved_other = (q.detach().cpu() - p0).double()
            off += int(((moved - moved_other).abs() > threshold * lr).sum())
            total += p.numel()
        out[group] = (off, total, share)
    return out


@contextlib.contextmanager
def crossing_threads():
    """The CPU's intra-op threads pinned to CROSSING_THREADS."""
    default = torch.get_num_threads()
    torch.set_num_threads(CROSSING_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(default)


def nudge_spreads(cfg, update_cpu, before, state_cpu, batch, draws, seed, count=NUDGES):
    """[{group: moves off}] of `count` CPU updates from `before` on the
    batch with its point states nudged by one ulp (each float in a random
    direction, from the generator of 1000 + seed, nudge after nudge), each
    against `state_cpu`, the CPU update of the batch itself from `before`."""
    batch = _cpu(batch)
    gen = torch.Generator().manual_seed(1000 + seed)
    out = []
    with crossing_threads():
        for _ in range(count):
            nudged = dict(batch)
            for key in ("point_state", "next_point_state"):
                x = batch[key]
                nudged[key] = torch.nextafter(x, x + torch.randn(x.shape, generator=gen).sign())
            state = before.to("cpu")
            update_cpu(state, nudged, noise_draws=draws.cpu())
            out.append({g: o for g, (o, _, _) in move_offs(cfg, before, state,
                                                           state_cpu).items()})
    return out


def scaled_pooled(kernels, eps):
    """K5's entry `kernels` (`sa_train._sa_train_kernels`) with its pooled
    output scaled by (1 + eps): the nudge rule's negative control."""
    def scaled(*args):
        pooled, stats = kernels(*args)
        return pooled * (1.0 + eps), stats

    return scaled


def synthetic_point_state(batch, gen, hand_points, device):
    """(B, 4, 1030) point states: 6 flagged hand anchors, then 1024
    points on the surface of a random ellipsoid 10-20 cm ahead."""
    n = 1024
    dirs = torch.randn((batch, n, 3), generator=gen, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    radii = 0.02 + 0.04 * torch.rand((batch, 1, 3), generator=gen, device=device)
    centre = torch.rand((batch, 1, 3), generator=gen, device=device) * 0.04 - 0.02
    centre[..., 2] += 0.15
    pts = dirs * radii + centre
    ps = torch.zeros((batch, 4, 6 + n), device=device)
    ps[:, :3, :6] = torch.as_tensor(hand_points, device=device)
    ps[:, 3, :6] = 1.0
    ps[:, :3, 6:] = pts.transpose(1, 2)
    return ps


def cuda_ms(fn, reps=10, rounds=7):
    """Median over `rounds` of the mean device time of `reps` calls.

    A spin kernel queued ahead of each round keeps the card busy for
    longer than the host takes to enqueue the calls, so the calls run
    back to back and the host's launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(2.0 * host_s * 2e9, 4e9))  # twice the enqueue time at <= 2 GHz
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, calls=5, ranges=(), count=False, host_ops=True):
    """(device busy ms per call, [(name, ms per call), ...] of every device
    activity by time, {range: device ms per call}) of `fn` under
    torch.profiler, and with `count` the number of device activities
    (kernel launches, copies) per call. Busy is the sum over device-side events (kernels,
    copies), each counted once; the CPU ops that launched them are left
    out, since they would count the same time again. `ranges` names
    `record_function` ranges whose device time (the kernels launched
    inside them) is reported. Without `host_ops` only device activity is
    traced (no ranges then): a call of tens of thousands of launches
    reads in a fraction of the time. 0 when the profiler saw no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # a range's own device-side annotation would count its kernels twice
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.key not in ranges]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    spans = {r: 0.0 for r in ranges}
    for e in prof.events():  # the kernels launched inside each range
        if e.name in spans and e.device_type == DeviceType.CPU:
            spans[e.name] += e.device_time_total / 1e3 / calls
    busy = sum(ms for _, ms in rows)
    if count:
        n = sum(e.count for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.key not in ranges)
        return busy, rows, spans, n / calls
    return busy, rows, spans


def bound_ms(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_peak(kernel):
    return PEAK_TF32X3_FLOPS if kernel in TENSOR_CORE_KERNELS else PEAK_FP32_FLOPS


def distinct_rows(idx):
    """Rows a grouped level's function needs on these indices: each
    group's distinct slots (ops/sa.py `distinct_slots`)."""
    from gaddpg_tpu_torch.ops.sa import distinct_slots

    return int(distinct_slots(idx)[0].sum().item())


def stress_groups(idx, n):
    """{label: (B, S, K) indices} that stress the K3/K5 compaction, from a
    level's ball-query groups `idx` over n points: every slot computed
    (slot 0, then K - 1 other indices, distinct while K <= n), every slot
    padded (the no-hit fallback), the ball query's own groups (K > N
    padding at SA2), out-of-range indices, and repeats that differ from
    slot 0."""
    b, s, k = idx.shape
    dev = idx.device
    base = idx[..., :1]
    ks = torch.arange(1, k, device=dev, dtype=torch.int32)
    others = lambda step: (base + 1 + ((ks - 1) // step) % (n - 1)) % n
    gen = torch.Generator(device=dev).manual_seed(5)
    wild = idx.clone()
    pick = torch.rand(idx.shape, generator=gen, device=dev)
    wild[pick < 0.1] = -1
    wild[(pick >= 0.1) & (pick < 0.2)] = n + 3
    wild[:, ::5, 0] = -2
    return {
        "all computed": torch.cat([base, others(1)], dim=-1),
        "all padded": base.expand(b, s, k).contiguous(),
        "ball query": idx,
        "out of range": wild,
        "repeats": torch.cat([base, others(3)], dim=-1),
    }


def zero_row_inputs(idx, full):
    """(idx, full) with a zero row appended to full and every index
    outside [0, n) sent to it: the function the kernels compute on any
    index, in a form the plain versions take."""
    n = full.shape[1]
    zero = torch.zeros_like(full[:, :1])
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, idx, torch.full_like(idx, n)), torch.cat([full, zero], dim=1)


def train_dense(level):
    """((w (C_in, C_out), b, BN scale, BN bias),) * 3 of an SA level."""
    return tuple((d.weight.t().contiguous(), d.bias, bn.weight, bn.bias)
                 for d, bn in zip(level.dense, level.norms))


def train_grads(fn, kernel, args):
    """Gradients of sum(pooled^2) through `fn` for the float inputs
    (full, cpad for a grouped level, the 12 parameters), from fresh
    leaves."""
    lead, dense = args[:-1], args[-1]
    floats = [t for t in lead if t.is_floating_point()]
    leaves = [t.detach().clone().requires_grad_()
              for t in (*floats, *(t for layer in dense for t in layer))]
    inputs, params = iter(leaves[:len(floats)]), leaves[len(floats):]
    call = [next(inputs) if t.is_floating_point() else t for t in lead]
    pooled, _ = fn(*call, tuple(tuple(params[4 * i: 4 * i + 4]) for i in range(3)))
    return torch.autograd.grad((pooled * pooled).sum(), leaves)


def check_train_grads(where, got_g, want_g, zero_biases=True):
    """Phase 2's gradient rule for a train level: each leaf within 1e-3
    of its own largest; the Dense biases feed a batch-stat BatchNorm, so
    their exact gradient is 0 and both sides hold only cancellation noise:
    each side within 1e-3 of the call's largest gradient of 0. A rank's
    share of a gradient under a mesh (zero_biases=False) is not 0 there:
    only the ranks' sum is, so every leaf takes the first rule. ->
    (largest difference, largest gradient)."""
    scale = max(w.abs().max().item() for w in want_g)
    gerr = max((g - w).abs().max().item() for g, w in zip(got_g, want_g))
    nin = len(got_g) - 12
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        if zero_biases and i >= nin and (i - nin) % 4 == 1:  # Dense bias
            zero = max(g.abs().max().item(), w.abs().max().item())
            if zero > 1e-3 * scale:
                raise AssertionError(f"{where}: Dense bias {(i - nin) // 4} gradient "
                                     f"{zero:.3e}, not 0")
            continue
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * w.abs().max().item(),
                                   msg=f"{where}: leaf {i}")
    return gerr, scale


def train_work(kernel, args):
    """(bytes, flops) the function of a train SA level needs on these
    inputs: each input read once, the pooled output and statistics
    written once, and each of the three Dense layers once per row: for a
    grouped level (K5), once per distinct slot of each group, the rows
    that give the pooled max and the batch sums. The group-all level (K6)
    has no padding: every row counts."""
    f32 = 4
    dense = args[-1]
    widths = [w.shape for w, _, _, _ in dense]
    macs = sum(a * b for a, b in widths)
    pbytes = sum(t.numel() for layer in dense for t in layer) * f32
    c3 = widths[-1][1]
    stats = 2 * sum(b for _, b in widths) * f32
    if kernel == "sa_train":
        idx, full, cpad, _ = args
        b, s, k = idx.shape
        nbytes = idx.numel() * 4 + (full.numel() + cpad.numel() + b * s * c3) * f32
        return nbytes + pbytes + stats, 2 * distinct_rows(idx) * macs
    full = args[0]
    b, n, _ = full.shape
    return (full.numel() + b * c3) * f32 + pbytes + stats, 2 * b * n * macs


def contact_scan_work(args, n):
    """(bytes, flops) of one contact scan of n substeps on these inputs.

    Bytes: each input read once, the (B, 16) output written once. FLOPs,
    counted from the substep (ops/contact_scan.py, the XLA substep of the
    JAX package), with a quaternion rotation 30, a cross product 9, a dot
    5, a norm 6, a division or square root 1:
    - per sphere: centre and hand-frame centre 66, table contact 11, the
      box SDF, normal, contact point and surface velocity of each of the
      three boxes 102 (306), the finger and gripper-flag tallies 11;
    - per contact (4 per sphere): normal force 99, the friction set-up 87,
      four friction passes 159, rigid-set stiction 25, torsion 60, and
      for the three pad contacts the rotational stiction 25;
    - per env: the box frames 99, the passive clamps, gyroscopic term,
      the four impulse applications and the stiction, damping,
      integration and finger updates, about 780, and 31 adds for each of
      the 48 per-env sums over 32 spheres.
    Every branch of the function is counted (the XLA substep computes
    both normals of every box contact)."""
    b = args[0].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args) + b * 16 * 4
    per_sphere = 66 + 11 + 306 + 11 + 4 * (99 + 87 + 159 + 25 + 60) + 3 * 25
    per_env = 32 * per_sphere + 780 + 48 * 31
    return nbytes, n * b * per_env


def launches_note(kernel):
    """The kernel's launches per call of the main path's entry points."""
    if kernel == "contact_scan":
        return (f"launches: {RESET_K7} per reset, {STEP_K7} per step, "
                f"{RETRACT_K7} per retract")
    return (f"launches: {PER_CALL[kernel]} per select_action, {DDPG_PER_UPDATE[kernel]} per "
            f"DDPG update, {BC_PER_UPDATE[kernel]} per BC update")


def fmt_list(t):
    """A 1-d tensor's values as a short bracketed list."""
    return "[" + ", ".join(f"{v:.1f}" for v in t.tolist()) + "]"


def physics_ratio(a, b):
    """(B,) largest departure of physics state a from b over the object
    and the fingers, in units of the phase-7 bounds."""
    fields = {"pos": (a.obj.pos, b.obj.pos), "quat": (a.obj.quat, b.obj.quat),
              "linvel": (a.obj.linvel, b.obj.linvel), "angvel": (a.obj.angvel, b.obj.angvel),
              "fingers": (a.arm.q[:, 7:9], b.arm.q[:, 7:9])}
    return torch.stack([((x - y).abs() / K7_BOUNDS[k][1]).amax(dim=1)
                        for k, (x, y) in fields.items()], dim=1).amax(dim=1)


def env_ratio(a, b):
    """(B,) largest departure of env state a from b over the target, the
    fingers and the clutter bodies, in units of the phase-7 bounds."""
    r = physics_ratio(a.phys, b.phys)
    if a.clutter_pos.shape[1]:
        rc = torch.stack([((getattr(a, f"clutter_{k}") - getattr(b, f"clutter_{k}")).abs()
                           / K7_BOUNDS[k][1]).flatten(1).amax(dim=1)
                          for k in ("pos", "quat", "linvel", "angvel")], dim=1).amax(dim=1)
        r = torch.maximum(r, rc)
    return r


def map_state(state, envs):
    from gaddpg_tpu_torch.physics.types import map_tensors

    return map_tensors(state, lambda t: t[envs])


def repeat_state(state, reps):
    from gaddpg_tpu_torch.physics.types import map_tensors

    return map_tensors(state, lambda t: t.repeat(reps, *([1] * (t.dim() - 1))))


def nudge_state(state, nudge):
    """state with its object positions (the clutter bodies' too) moved by
    one ulp."""
    state.phys.obj.pos = nudge(state.phys.obj.pos)
    if state.clutter_pos.numel():
        state.clutter_pos = nudge(state.clutter_pos)
    return state


def cat_states(states):
    """Env states (dataclasses of tensors, nested) joined along the batch."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: cat_states(vals) if dataclasses.is_dataclass(vals[0]) else torch.cat(vals)
        for f in dataclasses.fields(first) for vals in ([getattr(x, f.name) for x in states],)})


def one_ulp(t, gen):
    """`t` with every element moved by one ulp, up or down at random."""
    return torch.nextafter(t, t + torch.randn(t.shape, generator=gen, device=t.device).sign())


def nudge_env_state(state, gen):
    """Env states with the arm's seven joints and the object's position
    and orientation each moved by one ulp (`one_ulp`)."""
    q = state.phys.arm.q.clone()
    q[:, :7] = one_ulp(q[:, :7], gen)
    obj = state.phys.obj
    phys = dataclasses.replace(
        state.phys, arm=dataclasses.replace(state.phys.arm, q=q),
        obj=dataclasses.replace(obj, pos=one_ulp(obj.pos, gen), quat=one_ulp(obj.quat, gen)))
    return dataclasses.replace(state, phys=phys)


def plan_rule(label, plan_g, ok_g, plan_c, ok_c, probe, ok_flips=False):
    """The planner's card-vs-CPU rule (PLAN_TOL_CARD's comment) on
    (B, PLAN_STEPS, 7) plans and (B,) flags, CPU tensors. `probe(envs)`
    gives the CPU's plans and flags, (P, n, S, 7) and (P, n), from
    ULP_PROBES one-ulp nudges of those envs' planner inputs. With
    `ok_flips` a chaotic env's flag may differ too where one of the CPU's
    nudged plans flips its own (compare_env's rule for the env's flags).
    Returns {"chaotic": [...], "branch": [...], "left": [...]} of env
    indices; raises where the rule does not hold."""
    from gaddpg_tpu_torch.expert.chomp import APPROACH_STEPS
    from gaddpg_tpu_torch.robot.panda import fk_hand

    b = len(ok_c)
    err = (plan_g - plan_c).abs().amax(dim=(1, 2))
    k = APPROACH_STEPS - 1
    branch = (plan_g[:, k] - plan_c[:, k]).abs().amax(dim=1) > BRANCH_JOINT_TOL
    reach = (fk_hand(plan_g[:, -1])[:, :3, 3] - fk_hand(plan_c[:, -1])[:, :3, 3]).norm(dim=-1)
    off = ((err > PLAN_TOL_CARD) | (ok_g != ok_c)) & ~branch
    chaotic = torch.zeros(b, dtype=torch.bool)
    if off.any():
        envs = off.nonzero()[:, 0]
        plans, oks = probe(envs)
        spread = (plans - plan_c[envs]).abs().amax(dim=(0, 2, 3))
        same = ok_g[envs] == ok_c[envs]
        if ok_flips:
            same |= (oks != ok_c[envs]).any(dim=0)
        chaotic[envs] = (spread > PLAN_TOL_CARD) & (err[envs] <= PLAN_CHAOS * spread) & same
    left = off & ~chaotic
    first = lambda m: m.nonzero()[:, 0][:10].tolist()  # noqa: E731
    if branch.any() and ((reach[branch] > BRANCH_POSE_TOL).any()
                         or not torch.equal(ok_g[branch], ok_c[branch])):
        raise AssertionError(f"{label}: envs {first(branch)} on another IK branch reach "
                             f"{reach[branch][:10].tolist()} m apart, or their ok differs")
    if left.sum() > CHAOTIC_SHARE * b or (reach[left] > BRANCH_POSE_TOL).any():
        raise AssertionError(
            f"{label}: {int(left.sum())} of {b} envs off the plan rule (at most "
            f"{CHAOTIC_SHARE:.0%}), first {first(left)}: plans off by "
            f"{err[left][:10].tolist()}, ok {ok_g[left][:10].tolist()} vs "
            f"{ok_c[left][:10].tolist()}, reached poses {reach[left][:10].tolist()} m apart")
    return {"chaotic": first(chaotic), "n_chaotic": int(chaotic.sum()),
            "branch": first(branch), "n_branch": int(branch.sum()),
            "left": first(left), "n_left": int(left.sum()), "largest": err.max().item()}


def nn_miss_share(pts, ref, tol=1e-4):
    """Per env: share of the points pts (B, N, 3) farther than `tol` from
    every point of ref (B, M, 3) (a list of per-env clouds)."""
    out = []
    for p, r in zip(pts, ref):
        if r.shape[0] == 0:
            out.append(float(p.abs().sum() > 0))
            continue
        d = torch.cdist(p[None].double(), r[None].double())[0].min(dim=1).values
        out.append(float((d > tol).float().mean()))
    return out


class Smoke:
    def __init__(self):
        from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state
        from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
        from gaddpg_tpu_torch.ops import build, contact_scan, sa, sa_train, sampling

        self.build, self.sa, self.sa_train, self.sampling = build, sa, sa_train, sampling
        self.cs = contact_scan
        self.hand_points = HAND_FINGER_POINTS
        self.wrappers = kernel_wrappers()
        self.serving = ("fps", "ball_query", "sa_gather_mlp", "mlp_maxpool")
        self.cfg = AgentConfig()
        # the entry points at their default device="cuda", as a user calls them
        self.state = create_agent_state(self.cfg, generator=torch.Generator().manual_seed(0))
        # the learner's own state: its updates leave the serving state alone
        self.train_state = create_agent_state(self.cfg, TRAIN_POINTS,
                                          generator=torch.Generator().manual_seed(1))
        self.device = self.state.device
        self.errors = {k: 0.0 for k in self.wrappers}
        self.launches = {}
        self.per_iter = {}  # launches over one train iteration (phase 11)
        self.per_clutter_iter = {}  # and over one td3_clutter iteration (phase 12)
        self.per_goal_update = {}  # and per GoalFeature update (phase 13)
        self.per_image_iter = {}  # and over one image-mode iteration (phase 14)
        self.per_dp_iter = {}  # and on each of phase 16's ranks over one iteration
        self.per_image_dp_iter = {}  # and over its image iteration (phase 16)
        self.dp_image_split_ms = None  # ImageFeature's policy forward split, whole (phase 16)
        self.dp_split_ms = {}  # K5/K6 split at the reduction over 2 ranks (phase 16)
        self.card = card_line()
        self._scale2 = None

    def scale2(self):
        """(config, serving state, learner state) of a model_scale 2 agent
        (SA widths doubled: SA2 259 -> 256 -> 256 -> 512, SA3 515 -> 512 ->
        512 -> 1024), made at first use from seeded generators."""
        if self._scale2 is None:
            from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state

            cfg = AgentConfig(feature_dim=SCALE2_FEATURE)
            self._scale2 = (cfg,
                            create_agent_state(cfg, generator=torch.Generator().manual_seed(3)),
                            create_agent_state(cfg, TRAIN_POINTS,
                                               generator=torch.Generator().manual_seed(4)))
        return self._scale2

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    # -- the serving shapes, level by level ---------------------------------
    def level_inputs(self, point_state, state=None):
        """Per-kernel inputs of one policy-encoder forward of `state`
        (default: the serving state), computed with the plain versions:
        {kernel: [(label, args), ...]}."""
        sampling, sa = self.sampling, self.sa
        enc = (state or self.state).feat.encoder
        pc = point_state[:, :4, 6:].transpose(1, 2)
        xyz, feats = pc[..., :3].contiguous(), pc
        calls = {k: [] for k in self.serving}
        for (name, npoint, radius, nsample), level in zip(SA_LEVELS, enc.sa):
            weights = sa.folded_sa_weights(level.dense, level.norms)
            calls["fps"].append((name, (xyz, npoint)))
            centers = sampling.fps_reference(xyz, npoint)
            new_xyz = sampling.gather_points(xyz, centers)
            calls["ball_query"].append((name, (new_xyz, xyz, radius, nsample)))
            idx = sampling.ball_query_reference(new_xyz, xyz, radius, nsample)
            full = torch.cat([xyz, feats], dim=-1)
            cpad = torch.nn.functional.pad(new_xyz, (0, full.shape[-1] - 3))
            calls["sa_gather_mlp"].append((name, (idx, full, cpad, weights)))
            xyz, feats = new_xyz, sa.sa_gather_mlp_reference(idx, full, cpad, weights)
        weights = sa.folded_sa_weights(enc.sa[2].dense, enc.sa[2].norms)
        calls["mlp_maxpool"].append(("SA3", (torch.cat([xyz, feats], dim=-1), weights)))
        return calls

    def reference(self, kernel):
        return {
            "fps": self.sampling.fps_reference,
            "ball_query": self.sampling.ball_query_reference,
            "sa_gather_mlp": self.sa.sa_gather_mlp_reference,
            "mlp_maxpool": self.sa.mlp_maxpool_reference,
        }[kernel]

    # -- phase 2 --------------------------------------------------------------
    def check_kernels(self, gen):
        """K1-K4 at the serving shapes of the scale 1 and scale 2 agents."""
        scaled = (("", self.state), ("scale 2 ", self.scale2()[1]))
        for batch in CHECK_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            calls = [(kernel, tag + label, args) for tag, state in scaled
                     for kernel, level in self.level_inputs(ps, state).items()
                     for label, args in level
                     # the same clouds and centres at either scale
                     if not (tag and kernel in ("fps", "ball_query"))]
            for kernel, label, args in calls:
                self.check_call(kernel, label, args)

    def check_call(self, kernel, label, args):
        """A serving kernel against its plain version: indices equal,
        floats within 1e-4 (phase 2's bounds)."""
        batch = args[0].shape[0]
        got = self.wrappers[kernel](*args)
        torch.cuda.synchronize()
        want = self.reference(kernel)(*args)
        torch.cuda.synchronize()
        if got.dtype == torch.int32:
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"{kernel} {label} B={batch}: {bad} indices differ")
            err = 0.0
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err = (got - want).abs().max().item()
        self.errors[kernel] = max(self.errors[kernel], err)
        log(f"[check] {kernel:13s} {label} B={batch:4d} shape={tuple(got.shape)} "
            f"max_abs_err={err:.3e} ok")

    def check_fps(self, gen, clouds=None):
        """K1's indices exactly equal to fps_reference's: on tie-heavy
        clouds (FPS_TIE_SHAPES; a cloud of 8 points repeated, whose
        distances tie at every step, and points on an integer grid, whose
        squared distances are small integers) and on synthetic serving
        clouds at B = 1, 256, 1024; or, given `clouds` (B, N, 3), on
        their first 1, 256 and 1024 (the env's)."""
        sampling = self.sampling
        cases = []
        if clouds is None:
            for b, n in FPS_TIE_SHAPES:
                base = torch.rand((b, 8, 3), generator=gen, device=self.device)
                cases.append((f"repeated B={b} N={n}",
                              base.repeat(1, -(-n // 8), 1)[:, :n].contiguous()))
                grid = torch.randint(0, 4, (b, n, 3), generator=gen, device=self.device)
                cases.append((f"grid B={b} N={n}", grid.float()))
            for b in MAIN_BATCHES[:1] + (TRAIN_BATCH, ENV_BATCH):
                ps = synthetic_point_state(b, gen, self.hand_points, self.device)
                cases.append((f"synthetic B={b}", ps[:, :3, 6:].transpose(1, 2).contiguous()))
        else:
            for b in (1, TRAIN_BATCH, ENV_BATCH):
                cases.append((f"env B={b}", clouds[:b].contiguous()))
        npoint = SA_LEVELS[0][1]
        for label, xyz in cases:
            got = sampling.furthest_point_sampling(xyz, npoint)
            want = sampling.fps_reference(xyz, npoint)
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"fps {label}: {bad} indices differ")
            # SA2's input: the centres of SA1
            centres = sampling.gather_points(xyz, want).contiguous()
            if not torch.equal(sampling.furthest_point_sampling(centres, npoint),
                               sampling.fps_reference(centres, npoint)):
                raise AssertionError(f"fps {label} SA2: indices differ")
            log(f"[check] fps           {label} N={xyz.shape[1]}: indices equal at SA1 "
                "and SA2 ok")

    def check_ball_query(self, gen, clouds=None):
        """K2's indices exactly equal to ball_query_reference's, and two
        launches bit-identical: on synthetic serving clouds at B = 1, 256,
        1024 (SA1 on the cloud's FPS centres, SA2 on those centres), on
        K2_CASES (points N(0, 0.05), centres drawn from them), on far
        centres with no hit whose nearest point is repeated, on an integer
        grid (distances exactly at r), and at r = 0 (hits only on the
        centre's copies); or, given `clouds` (B, N, 3), SA1 and SA2 on
        their first 1, 256 and 1024 (the env's)."""
        sampling, dev = self.sampling, self.device
        (_, npoint, r1, k1), (_, _, r2, k2) = SA_LEVELS
        cases = []
        for b in (1, TRAIN_BATCH, ENV_BATCH):
            if clouds is None:
                ps = synthetic_point_state(b, gen, self.hand_points, dev)
                xyz, tag = ps[:, :3, 6:].transpose(1, 2).contiguous(), "synthetic"
            else:
                xyz, tag = clouds[:b].contiguous(), "env"
            centres = sampling.gather_points(xyz, sampling.fps_reference(xyz, npoint))
            cases.append((f"{tag} SA1 B={b}", centres, xyz, r1, k1))
            sa2 = sampling.gather_points(centres, sampling.fps_reference(centres, npoint))
            cases.append((f"{tag} SA2 B={b}", sa2.contiguous(), centres.contiguous(), r2, k2))
        if clouds is None:
            for label, n, s, radius, nsample in K2_CASES:
                xyz = 0.05 * torch.randn((8, n, 3), generator=gen, device=dev)
                pick = torch.randint(0, n, (8, s), generator=gen, device=dev)
                cases.append((label, sampling.gather_points(xyz, pick), xyz, radius, nsample))
            base = torch.rand((8, 8, 3), generator=gen, device=dev)
            rep = base.repeat(1, 9, 1)[:, :70].contiguous()
            far = torch.tensor([[3.0, 0.5, 0.5], [-2.0, 0.2, 0.0], [0.5, 0.5, 9.0]], device=dev)
            cases.append(("far centres, nearest repeated",
                          torch.cat([rep[:, :4], far.expand(8, 3, 3)], dim=1), rep, 0.01, 16))
            grid = torch.randint(0, 4, (8, 100, 3), generator=gen, device=dev).float()
            shift = 0.5 * (torch.rand((8, 13, 1), generator=gen, device=dev) > 0.5)
            cases.append(("integer grid", grid[:, :13] + shift, grid, 1.0, 8))
            cases.append(("r=0", rep[:, 3:16].contiguous(), rep, 0.0, 12))
        for label, centres, xyz, radius, nsample in cases:
            got = sampling.ball_query(centres, xyz, radius, nsample)
            again = sampling.ball_query(centres, xyz, radius, nsample)
            want = sampling.ball_query_reference(centres, xyz, radius, nsample)
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"ball_query {label}: {bad} indices differ")
            if not torch.equal(got, again):
                raise AssertionError(f"ball_query {label}: two launches differ")
            d2 = sampling._sq_dist(centres[:, :, None, :], xyz[:, None, :, :])
            hits = (d2 <= sampling._radius_sq(radius)).sum(dim=-1)
            b, s, n = centres.shape[0], centres.shape[1], xyz.shape[1]
            per = sampling.ball_query_layout(b, s, n, nsample, sampling.sm_count(xyz.device.index))[0]
            log(f"[check] ball_query    {label} (B={b}, S={s}, N={n}, r={radius}, "
                f"nsample={nsample}, {per} centres a block): "
                f"hits {int(hits.min())}-{int(hits.max())}, {int((hits == 0).sum())} centres "
                f"without, {int((hits >= nsample).sum())} with a full row; indices equal, two "
                "launches bit-identical ok")

    def check_valid_masks(self, gen):
        """FPS and ball query with `valid=` all true at one serving shape
        (B=8, SA1 and SA2) on the card: the masked call runs the plain
        version (as the JAX package serves a mask from XLA), launches no
        kernel, and gives the kernels' indices."""
        sampling = self.sampling
        (_, n1, r1, k1), (_, n2, r2, k2) = SA_LEVELS
        ps = synthetic_point_state(8, gen, self.hand_points, self.device)
        xyz = ps[:, :3, 6:].transpose(1, 2).contiguous()
        centres = sampling.gather_points(xyz, sampling.furthest_point_sampling(xyz, n1))
        sa2 = sampling.gather_points(centres, sampling.furthest_point_sampling(centres, n2))
        for label, (pts, ctr, npoint, radius, nsample) in (
                ("SA1", (xyz, centres.contiguous(), n1, r1, k1)),
                ("SA2", (centres.contiguous(), sa2.contiguous(), n2, r2, k2))):
            valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=self.device)
            want_f = sampling.furthest_point_sampling(pts, npoint)
            want_b = sampling.ball_query(ctr, pts, radius, nsample)
            before = self.counts()
            got_f = sampling.furthest_point_sampling(pts, npoint, valid=valid)
            got_b = sampling.ball_query(ctr, pts, radius, nsample, valid=valid)
            torch.cuda.synchronize()
            if self.counts() != before:
                raise AssertionError(f"valid= {label}: a masked call launched a kernel")
            if not (torch.equal(got_f, want_f) and torch.equal(got_b, want_b)):
                raise AssertionError(f"valid= {label}: the masked indices differ from K1/K2's")
            log(f"[check] valid=        {label} B=8 N={pts.shape[1]}: FPS and ball query with "
                f"an all-true mask (the plain version on the card, no launch) equal K1's and "
                f"K2's indices ok")

    def check_k4(self, gen):
        """K4 (mlp_maxpool) against its plain version within 1e-4 at B =
        1, 3, 256 and 1024 (one, two, 64 and 256 full 128-row tiles:
        partial and ragged tiles included) on both branches of its width
        test: the fused wgmma kernel on the serving shapes' SA3 input at
        scale 1, the layer engine of K6 on the scale 2 agent's (515 -> 512
        -> 512 -> 1024); and on a batch whose last layer's pre-activations
        are all negative (a max of zeros); two calls bit-identical each.
        Times each (CUDA events). At B = 256 and 1024 the layer engine runs
        the fused branch's inputs too, against the plain version, and is
        timed beside the fused kernel: the reason for the width test."""
        sa = self.sa
        for batch in K4_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            cases = []
            for tag, state in (("", self.state), ("scale 2 ", self.scale2()[1])):
                (label, (full, weights)), = self.level_inputs(ps, state)["mlp_maxpool"]
                cin, widths = full.shape[-1], [w.shape[1] for w, _ in weights]
                branch = "fused" if sa.k4_fused_takes(cin, *widths) else "engine"
                cases.append((f"{tag}{label} B={batch} ({branch})", full, weights))
                if batch == 3:
                    (w1, b1), layer2, (w3, b3) = weights
                    cases.append((f"{tag}{label} B={batch} ({branch}) layer 3 all negative",
                                  full, ((w1, b1), layer2, (w3, b3 - 1e4))))
            if batch == K4_BATCHES[0]:
                self.check_weight_pack(cases)
            for name, x, ws in cases:
                got, again = sa.mlp_maxpool(x, ws), sa.mlp_maxpool(x, ws)
                want = sa.mlp_maxpool_reference(x, ws)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
                if not torch.equal(got, again):
                    raise AssertionError(f"mlp_maxpool {name}: two calls differ")
                err = (got - want).abs().max().item()
                self.errors["mlp_maxpool"] = max(self.errors["mlp_maxpool"], err)
                ms = cuda_ms(lambda: sa.mlp_maxpool(x, ws))
                log(f"[check] mlp_maxpool   {name}: max_abs_err={err:.3e}, "
                    f"{int((want == 0).sum())} of {want.numel()} outputs 0, two calls "
                    f"bit-identical, kernel {ms:.4f} ms ok")
                if "(fused)" in name and batch >= 256 and "negative" not in name:
                    engine = sa.groupall_engine(x, ws)[0]
                    torch.testing.assert_close(engine, want, rtol=1e-4, atol=1e-4)
                    ems = cuda_ms(lambda: sa.groupall_engine(x, ws))
                    log(f"[check] mlp_maxpool   {name}: the layer engine on the same input "
                        f"max_abs_err={(engine - want).abs().max().item():.3e}, "
                        f"{ems:.4f} ms against the fused kernel's {ms:.4f} ms ok")

    def check_weight_pack(self, cases):
        """The weight-pack kernel of K4 and K6 (`layer_weight_pack` on the
        card) equal bit for bit to its plain version on every layer of
        `cases` [(name, full, weights)]: the TF32 split rounds as the
        card's cvt.rna does."""
        for name, _, ws in cases:
            for i, (w, _) in enumerate(ws):
                got = self.sa.layer_weight_pack(w)
                want = self.sa.layer_weight_pack_reference(w)
                if not torch.equal(got, want):
                    raise AssertionError(f"weight pack {name} layer {i + 1}: differs from "
                                         "the plain version")
            log(f"[check] weight pack   {name}: {len(ws)} layers bit-identical to the plain "
                "version ok")

    # -- phase 3 --------------------------------------------------------------
    def main_path(self, gen):
        from gaddpg_tpu_torch.agents import make_select_action
        from gaddpg_tpu_torch.ops import sampling

        select = make_select_action(self.cfg)
        select_cpu = make_select_action(self.cfg, device="cpu")
        state_cpu = self.state.to("cpu")
        inputs = {}
        for batch in MAIN_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            remain = torch.full((batch,), 10.0, device=self.device)
            inputs[batch] = (ps, remain)
        outs = {}
        per_call = []
        self.reset_counts()
        for batch, (ps, remain) in inputs.items():
            before = self.counts()
            outs[batch] = select(self.state, ps, remain)
            after = self.counts()
            per_call.append((batch, {k: after[k] - before[k] for k in after}))
        torch.cuda.synchronize()
        self.launches = self.counts()
        for batch, delta in per_call:
            log(f"[main] select_action B={batch}: launches {delta}")
            if delta != PER_CALL:
                raise AssertionError(f"B={batch}: launches {delta}, expected {PER_CALL}")

        for batch, (ps, remain) in inputs.items():
            xyz = ps[:, :3, 6:].transpose(1, 2).contiguous()
            xyz_cpu = xyz.cpu()
            idx = sampling.furthest_point_sampling(xyz, 32)
            idx_cpu = sampling.furthest_point_sampling(xyz_cpu, 32)
            if not torch.equal(idx.cpu(), idx_cpu):
                raise AssertionError(f"B={batch}: FPS indices differ card vs CPU")
            centers = sampling.gather_points(xyz, idx)
            bq = sampling.ball_query(centers, xyz, 0.02, 64)
            bq_cpu = sampling.ball_query(centers.cpu(), xyz_cpu, 0.02, 64)
            if not torch.equal(bq.cpu(), bq_cpu):
                raise AssertionError(f"B={batch}: ball-query indices differ card vs CPU")
            action, aux = outs[batch]
            action_cpu, aux_cpu = select_cpu(state_cpu, ps.cpu(), remain.cpu())
            for name, got, want in (("action", action, action_cpu), ("aux", aux, aux_cpu)):
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"B={batch}: {name} shape/finite check failed")
                torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
            err = max((action.cpu() - action_cpu).abs().max().item(),
                      (aux.cpu() - aux_cpu).abs().max().item())
            log(f"[main] select_action B={batch}: indices equal, "
                f"card vs CPU max_abs_err={err:.3e} ok")
        return select, inputs

    # -- phase 4 --------------------------------------------------------------
    def runner(self):
        from gaddpg_tpu_torch.deploy.runner import Frame, PolicyRunner

        h, w = 480, 640
        rng = np.random.default_rng(0)
        depth = np.zeros((h, w), np.float32)
        depth[180:300, 260:380] = 0.35 + 0.01 * rng.random((120, 120), dtype=np.float32)
        hand = np.eye(4)
        hand[:3, 3] = (0.0, 0.0, 0.5)
        cam = hand.copy()
        frame = Frame(depth=depth, target_mask=depth > 0,
                      intrinsics=np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]),
                      cam_to_world=cam, hand_to_world=hand)
        max_steps, retract_steps = 12, 3
        runner = PolicyRunner(self.state, self.cfg, max_steps=max_steps,
                              retract_steps=retract_steps, termination=False)
        self.reset_counts()
        phases, lat = [], []
        for _ in range(max_steps + retract_steps + 2):
            t0 = time.perf_counter()
            cmd = runner(frame)
            lat.append((time.perf_counter() - t0) * 1e3)
            phases.append(cmd.phase)
            if cmd.delta_pose.shape != (6,) or not np.isfinite(cmd.delta_pose).all():
                raise AssertionError(f"bad command {cmd}")
        expect = (["APPROACH"] * max_steps + ["RETRACT"] * (retract_steps + 1) + ["DONE"])
        if phases != expect:
            raise AssertionError(f"runner phases {phases}")
        counts = self.counts()
        if counts != {k: v * max_steps for k, v in PER_CALL.items()}:
            raise AssertionError(f"runner launches {counts}")
        approach = lat[1:max_steps]  # the first tick warms the builder
        log(f"[runner] phases {' '.join(phases)}")
        log(f"[runner] launches over {max_steps} APPROACH ticks: {counts}")
        log(f"[runner] APPROACH tick latency median {statistics.median(approach):.3f} ms "
            f"(min {min(approach):.3f}, max {max(approach):.3f}, n={len(approach)}), "
            f"480x640 depth frames")

    # -- phase 5 --------------------------------------------------------------
    def work(self, kernel, args):
        """(bytes, flops) the function needs on these inputs: K3's Dense
        layers once per distinct slot of each group (`train_work` says
        why)."""
        f32 = 4
        if kernel == "fps":
            xyz, npoint = args
            b, n, _ = xyz.shape
            return b * n * 3 * f32 + b * npoint * 4, 9 * b * n * (npoint - 1)
        if kernel == "ball_query":
            centers, xyz, radius, nsample = args
            b, s, _ = centers.shape
            n = xyz.shape[1]
            d2 = self.sampling._sq_dist(centers[:, :, None, :], xyz[:, None, :, :])
            hits = (d2 <= self.sampling._radius_sq(radius)).cumsum(dim=-1)
            reach = (hits >= nsample).int().argmax(dim=-1) + 1
            scanned = torch.where(hits[..., -1] >= nsample, reach, torch.full_like(reach, n))
            nbytes = (b * s * 3 + b * n * 3) * f32 + b * s * nsample * 4
            return nbytes, 9 * int(scanned.sum().item())
        if kernel == "sa_gather_mlp":
            idx, full, cpad, weights = args
            b, s, k = idx.shape
            wbytes = sum(w.numel() + bb.numel() for w, bb in weights) * f32
            macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
            c3 = weights[-1][0].shape[1]
            nbytes = idx.numel() * 4 + (full.numel() + cpad.numel() + b * s * c3) * f32 + wbytes
            return nbytes, 2 * distinct_rows(idx) * macs
        full, weights = args
        b, n, _ = full.shape
        wbytes = sum(w.numel() + bb.numel() for w, bb in weights) * f32
        macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
        c3 = weights[-1][0].shape[1]
        return full.numel() * f32 + wbytes + b * c3 * f32, 2 * b * n * macs

    @staticmethod
    def distinct_note(kernel, args):
        """For K3 and K5: the share of their groups' slots that are
        distinct, the rows their bound counts."""
        if kernel not in ("sa_gather_mlp", "sa_train"):
            return ""
        idx = args[0]
        return f"; distinct rows {distinct_rows(idx) / idx.numel():.4f} of the slots"

    def time_serving(self, kernel, label, batch, args):
        """One serving kernel and its plain version (CUDA events) and the
        function's bound -> (ms, plain ms, bytes, flops)."""
        ms = cuda_ms(lambda: self.wrappers[kernel](*args))
        plain = cuda_ms(lambda: self.reference(kernel)(*args), reps=3, rounds=5)
        nbytes, flops = self.work(kernel, args)
        bms, by = bound_ms(nbytes, flops, kernel_peak(kernel))
        log(f"[time] {kernel:13s} {label} B={batch:4d} kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; "
            f"{nbytes} B, {flops} FLOP){self.distinct_note(kernel, args)}; "
            f"{launches_note(kernel)}")
        return ms, plain, nbytes, flops

    def timings(self, select, inputs, gen):
        totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0} for k in self.serving}
        for batch in TIME_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            for kernel, calls in self.level_inputs(ps).items():
                for label, args in calls:
                    ms, plain, nbytes, flops = self.time_serving(kernel, label, batch, args)
                    if batch == TIME_BATCHES[-1]:
                        t = totals[kernel]
                        t["ms"] += ms
                        t["plain_ms"] += plain
                        t["bytes"] += nbytes
                        t["flops"] += flops
        k2_gen = torch.Generator(device=self.device).manual_seed(K2_SEED)
        for batch in K2_TIME_BATCHES:
            ps = synthetic_point_state(batch, k2_gen, self.hand_points, self.device)
            for label, args in self.level_inputs(ps)["ball_query"]:
                self.time_serving("ball_query", label, batch, args)
        for batch, (ps, remain) in inputs.items():
            call = lambda: select(self.state, ps, remain)
            ms = host_ms(call, reps=20 if batch < 256 else 10)
            log(f"[time] select_action B={batch:4d}: {ms:.3f} ms per call (host clock, "
                f"synchronised), {ms / batch:.4f} ms per request")
            busy, rows, _ = device_profile(call)
            if busy == 0:
                log(f"[profile] select_action B={batch:4d}: device time not measured "
                    "(the profiler saw no device activity)")
                continue
            log(f"[profile] select_action B={batch:4d}: device busy {busy:.4f} ms per call, "
                f"idle share {max(0.0, 1 - busy / ms):.3f} of the host-clock call")
            for name, t in rows[:6]:
                log(f"[profile]   {t:.4f} ms  {name[:100]}")
        return totals

    # -- K5/K6 at the learner's shapes -------------------------------------------
    def train_level_inputs(self, point_state, action=None, state=None):
        """[(label, kernel, args)] of one train-mode encoder forward (the
        value encoder when `action` is given) at each level, computed with
        the plain versions on the weights of `state` (default: the learner
        state)."""
        sampling, sa_train = self.sampling, self.sa_train
        feat = (state or self.train_state).feat
        if action is None:
            tag, enc, pc = "policy", feat.encoder, feat._prep(point_state, feat.policy_in)
        else:
            tag, enc = "value", feat.value_encoder
            tiled = action[:, :, None].expand(*action.shape, point_state.shape[-1])
            pc = feat._prep(torch.cat([point_state, tiled], dim=1), feat.value_in)
        xyz, feats = pc[..., :3].contiguous(), pc
        calls = []
        for (name, npoint, radius, nsample), level in zip(SA_LEVELS, enc.sa):
            dense = train_dense(level)
            new_xyz = sampling.gather_points(xyz, sampling.fps_reference(xyz, npoint))
            idx = sampling.ball_query_reference(new_xyz, xyz, radius, nsample)
            full = torch.cat([xyz, feats], dim=-1)
            cpad = torch.nn.functional.pad(new_xyz, (0, full.shape[-1] - 3))
            calls.append((f"{tag} {name}", "sa_train", (idx, full, cpad, dense)))
            xyz, feats = new_xyz, sa_train.sa_train_reference(idx, full, cpad, dense)[0]
        calls.append((f"{tag} SA3", "groupall_train",
                      (torch.cat([xyz, feats], dim=-1), train_dense(enc.sa[2]))))
        return calls

    def train_reference(self, kernel):
        return {"sa_train": self.sa_train.sa_train_reference,
                "groupall_train": self.sa_train.groupall_train_reference}[kernel]

    def train_calls(self, batch, gen, state=None):
        """The policy encoder's three levels and the value encoder's SA1."""
        ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
        action = torch.rand((batch, 6), generator=gen, device=self.device) * 0.1 - 0.05
        with torch.no_grad():
            value = [c for c in self.train_level_inputs(ps, action, state)
                     if c[0] == "value SA1"]
            return self.train_level_inputs(ps, state=state) + value

    def check_train_kernels(self, gen):
        """K5 and K6 at the learner's shapes of the scale 1 and scale 2
        agents."""
        for tag, state in (("", None), ("scale 2 ", self.scale2()[2])):
            for batch in CHECK_BATCHES:
                for label, kernel, args in self.train_calls(batch, gen, state):
                    self.check_train_call(tag + label, kernel, args, batch)

    def check_train_call(self, label, kernel, args, batch, ref_args=None, grads=True):
        """The kernels' pooled output and statistics against the plain
        version on `ref_args` (default `args`) within 1e-4, statistics
        bit-identical over two calls, and with `grads` the gradients
        through the wrapper within 1e-3."""
        with torch.no_grad():
            got, stats = self.wrappers[kernel](*args)
            got2, again = self.wrappers[kernel](*args)
            torch.cuda.synchronize()
            want, want_stats = self.train_reference(kernel)(*(ref_args or args))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        if not torch.equal(got, got2):
            raise AssertionError(f"{kernel} {label} B={batch}: pooled output differs between "
                                 "two calls")
        err = (got - want).abs().max().item()
        for mv, want_mv, mv2 in zip(stats, want_stats, again):
            for t, w, t2 in zip(mv, want_mv, mv2):
                torch.testing.assert_close(t, w, rtol=1e-4, atol=1e-4)
                err = max(err, (t - w).abs().max().item())
                if not torch.equal(t, t2):
                    raise AssertionError(f"{kernel} {label} B={batch}: statistics "
                                         "differ between two calls")
        self.errors[kernel] = max(self.errors[kernel], err)
        note = "no gradient (indices outside [0, N): the plain backward takes none)"
        if grads:
            # each leaf's gradient within 1e-3 of its own largest; the
            # Dense biases feed a batch-stat BatchNorm, so their exact
            # gradient is 0 and both sides hold only cancellation noise:
            # each side within 1e-3 of the call's largest gradient of 0
            gerr, scale = check_train_grads(
                f"{kernel} {label} B={batch}",
                *(train_grads(fn, kernel, args) for fn in
                  (self.wrappers[kernel], self.train_reference(kernel))))
            note = f"grad max_abs_err={gerr:.3e} (largest grad {scale:.3e})"
        log(f"[check] {kernel:14s} {label:10s} B={batch:4d} pooled+stats "
            f"max_abs_err={err:.3e}, {note}, pooled and stats bit-identical over two calls ok")

    def check_compaction(self, gen):
        """K3 and K5 at B=8 on groups that stress the compaction
        (`stress_groups`) at SA1 and SA2, against their plain versions on
        the zero-row form of the same inputs (`zero_row_inputs`): outputs
        and statistics within 1e-4, two calls bit-identical (K3's pooled
        output, K5's statistics), K5's gradients within 1e-3 where the
        indices lie in [0, N)."""
        batch = CHECK_BATCHES[0]
        ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
        with torch.no_grad():
            for label, (idx, full, cpad, weights) in self.level_inputs(ps)["sa_gather_mlp"]:
                for kind, sidx in stress_groups(idx, full.shape[1]).items():
                    got = self.sa.sa_gather_mlp(sidx, full, cpad, weights)
                    again = self.sa.sa_gather_mlp(sidx, full, cpad, weights)
                    zidx, zfull = zero_row_inputs(sidx, full)
                    want = self.sa.sa_gather_mlp_reference(zidx, zfull, cpad, weights)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
                    if not torch.equal(got, again):
                        raise AssertionError(f"sa_gather_mlp {label} {kind}: two calls differ")
                    err = (got - want).abs().max().item()
                    self.errors["sa_gather_mlp"] = max(self.errors["sa_gather_mlp"], err)
                    log(f"[check] sa_gather_mlp {label} {kind:12s} B={batch}: distinct rows "
                        f"{distinct_rows(sidx) / sidx.numel():.4f} of the slots, "
                        f"max_abs_err={err:.3e}, two calls bit-identical ok")
        for label, kernel, args in self.train_calls(batch, gen):
            if kernel != "sa_train":
                continue
            idx, full, cpad, dense = args
            for kind, sidx in stress_groups(idx, full.shape[1]).items():
                inside = bool(((sidx >= 0) & (sidx < full.shape[1])).all())
                zidx, zfull = zero_row_inputs(sidx, full)
                self.check_train_call(f"{label} {kind}", kernel, (sidx, full, cpad, dense),
                                      batch, ref_args=(zidx, zfull, cpad, dense), grads=inside)

    # -- phase 6 ------------------------------------------------------------------
    def learner_batch(self, batch, gen):
        """bench.py's learner batch (bench.py:101-117): a 4 x 1030 point
        state of N(0, 0.05) points with the 6 flagged anchors, all expert
        rows with return 1, no reward, no terminal."""
        d = self.device
        ps = torch.randn((batch, 4, TRAIN_POINTS), generator=gen, device=d) * 0.05
        ps[:, 3, :] = 0.0
        ps[:, 3, :6] = 1.0
        goal = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.1], device=d).repeat(batch, 1)
        ones, zeros = torch.ones(batch, device=d), torch.zeros(batch, device=d)
        return {
            "point_state": ps, "next_point_state": ps,
            "action": torch.rand((batch, 6), generator=gen, device=d) * 0.1 - 0.05,
            "expert_action": torch.rand((batch, 6), generator=gen, device=d) * 0.1 - 0.05,
            "reward": zeros, "return": ones, "terminal": zeros,
            "time": torch.full((batch,), 10.0, device=d), "goal": goal, "next_goal": goal,
            "expert_flags": ones, "perturb_flags": zeros,
        }

    def learner(self, gen):
        from gaddpg_tpu_torch.agents import make_bc_update, make_ddpg_update

        ddpg, bc = make_ddpg_update(self.cfg), make_bc_update(self.cfg)
        state, batch = self.train_state, self.learner_batch(TRAIN_BATCH, gen)
        runs = (("ddpg", lambda: ddpg(state, batch, gen), DDPG_PER_UPDATE),
                ("bc", lambda: bc(state, batch), BC_PER_UPDATE))
        total = {k: 0 for k in self.wrappers}
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name, update, per in runs:
            times[name] = []
            for i in range(1 + TIMED_UPDATES):  # the first warms up
                self.reset_counts()
                t0 = time.perf_counter()
                metrics = update()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = self.counts()
                if counts != per:
                    raise AssertionError(f"{name} update {i}: launches {counts}, expected {per}")
                bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
                if bad:
                    raise AssertionError(f"{name} update {i}: non-finite metrics {bad}")
                for k in total:
                    total[k] += counts[k]
                if i:
                    times[name].append(ms)
                log(f"[learner] {name} update {i} B={TRAIN_BATCH}x{TRAIN_POINTS}: {ms:.3f} ms, "
                    f"launches {counts}, " + ", ".join(
                        f"{k} {float(v):.5g}" for k, v in metrics.items()))
        peak = torch.cuda.max_memory_allocated() / 2**30
        self.launches["sa_train"] = total["sa_train"]
        self.launches["groupall_train"] = total["groupall_train"]
        log(f"[learner] launches over {1 + TIMED_UPDATES} DDPG + {1 + TIMED_UPDATES} BC "
            f"updates: {total}")
        for name, ts in times.items():
            log(f"[time] {name} update B={TRAIN_BATCH}x{TRAIN_POINTS}: median "
                f"{statistics.median(ts):.3f} ms (host clock, synchronised; "
                f"min {min(ts):.3f}, max {max(ts):.3f}, n={len(ts)})")
        log(f"[memory] learner peak allocated {peak:.3f} GiB")
        for name, update, _ in runs:
            self.profile_update(name, update, statistics.median(times[name]))
        self.card_vs_cpu(gen)

    def profile_update(self, name, update, host_ms):
        busy, rows, spans = device_profile(update, calls=2,
                                           ranges=(self.sa_train.BACKWARD_RANGE,))
        if busy == 0:
            log(f"[profile] {name} update: device time not measured "
                "(the profiler saw no device activity)")
            return
        parts = {"K5 compaction, layer passes and pooling": (
                     "count_distinct_kernel", "scan_counts_kernel", "fill_rows_kernel",
                     "sa_train_layer_kernel", "sa_train_pool_kernel"),
                 "K5/K6 statistics reductions": ("reduce_stats_kernel",),
                 "K6 weight packs, layer passes and pooling": (
                     "weight_pack_kernel", "groupall_layer_kernel", "groupall_pool_kernel"),
                 "K1/K2": ("fps_kernel", "ball_query_kernel")}
        split = {p: sum(ms for key, ms in rows if any(n in key for n in names))
                 for p, names in parts.items()}
        stray = [key for key, _ in rows if "mlp_maxpool_kernel" in key]
        if stray:  # K6 pools itself: a train update runs no K4
            raise AssertionError(f"{name} update ran {stray}")
        backward = spans.get(self.sa_train.BACKWARD_RANGE, 0.0)
        log(f"[profile] {name} update: device busy {busy:.3f} ms per update, idle share "
            f"{max(0.0, 1 - busy / host_ms):.3f} of the {host_ms:.3f} ms host-clock update")
        for part, ms in split.items():
            log(f"[profile]   {part}: {ms:.3f} ms")
        log(f"[profile]   plain backward recompute of K5/K6 ({self.sa_train.BACKWARD_RANGE}): "
            + (f"{backward:.3f} ms" if backward else "not measured"))
        log(f"[profile]   rest (FC trunk, heads, losses, optimizers, copies): "
            f"{busy - sum(split.values()) - backward:.3f} ms")
        for key, ms in rows[:8]:
            log(f"[profile]   {ms:.4f} ms  {key[:100]}")

    def mixed_batch(self, batch, gen):
        """The learner batch with every mask live: non-expert rows, rows
        of return 0 (so the actor term has rows), rewards, terminals, a
        perturbed row and one positive collide_future."""
        out = self.learner_batch(batch, gen)
        rows = torch.arange(batch, device=self.device)
        out["expert_flags"] = (rows % 2 == 0).float()
        out["return"] = (rows % 3 != 0).float()
        out["reward"] = 0.5 * (rows % 4 == 1).float()
        out["terminal"] = (rows % 4 == 3).float()
        out["perturb_flags"] = (rows == batch - 4).float()
        out["collide_future"] = (rows == 2).float()
        return out

    def card_vs_cpu(self, gen, updates=2):
        """Two DDPG updates at B=8 on the card and on the CPU from the same
        state, batch and smoothing draws, with the Q2 hard copy and the
        collision terms on. The state carries Adam moments from one
        earlier CPU update: on Adam's first step every move is +-lr by
        the gradient's sign, so the rounding of the gradients near 0
        would decide moves. The first update (update_step 0) runs the
        actor term; the second runs through the stepped parameters, on
        both devices from the CPU's state after the first, carried to the
        card: each update is compared from a common state, as
        tests/test_torch_learner.py compares one update, whose bounds
        these are. Chained from each device's own first update, the
        second compounds Adam's response to gradients within rounding of
        0: PR 3's kernels and these alike then miss the 1e-3 metric bound
        on most batches."""
        cfg, update, update_cpu, state_cpu = self.b8_learner(self.cfg.feature_dim)
        batches = [self.mixed_batch(8, gen) for _ in range(1 + updates)]
        draws = [torch.rand((8, 6), generator=gen, device=self.device) for _ in batches]
        state, before = self.b8_start(update_cpu, state_cpu, batches[0], draws[0])
        err = 0.0
        for i in range(1, 1 + updates):
            err = max(err, self.b8_update(update, update_cpu, state, state_cpu, batches[i],
                                          draws[i], actor=i == 1))
            if i == 1:
                serr, _ = self.compare_updated(cfg, before, state, state_cpu)
                state = state_cpu.to(self.device)
        log(f"[learner] ddpg updates B=8: indices equal, card vs CPU metrics of {updates} "
            f"update(s) max_abs_err={err:.3e}, running statistics max_abs_err={serr:.3e}, "
            f"parameter and target moves within bounds ok")

    def b8_learner(self, feature_dim, compute_dtype="float32"):
        """(config, card update, CPU update, CPU state) of the B=8 card-vs-CPU
        updates, with the Q2 hard copy and the collision terms on."""
        from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state, make_ddpg_update

        cfg = AgentConfig(feature_dim=feature_dim, target_update_interval=1,
                          collision_aux_weight=0.1, collision_demo_discount=0.5,
                          compute_dtype=compute_dtype)
        state_cpu = create_agent_state(cfg, generator=torch.Generator().manual_seed(2),
                                       device="cpu")
        return cfg, make_ddpg_update(cfg), make_ddpg_update(cfg, device="cpu"), state_cpu

    def b8_start(self, update_cpu, state_cpu, batch, draws):
        """One CPU update of `state_cpu` in place (Adam moments to carry),
        then update_step back to 0 (the actor term on) -> (its copy on the
        card, its copy on the CPU)."""
        update_cpu(state_cpu, _cpu(batch), noise_draws=draws.cpu())
        state_cpu.update_step = 0
        return state_cpu.to(self.device), state_cpu.to("cpu")

    def b8_update(self, update, update_cpu, state, state_cpu, batch, draws, actor):
        """One update of `state` on the card and of `state_cpu` on the CPU
        from the same batch and draws: FPS and ball-query indices equal on
        both, metrics within 1e-3 -> the metrics' largest difference."""
        xyz = batch["point_state"][:, :3, 6:].transpose(1, 2).contiguous()
        idx = self.sampling.furthest_point_sampling(xyz, 32)
        centers = self.sampling.gather_points(xyz, idx)
        if not (torch.equal(idx.cpu(), self.sampling.furthest_point_sampling(xyz.cpu(), 32))
                and torch.equal(self.sampling.ball_query(centers, xyz, 0.02, 64).cpu(),
                                self.sampling.ball_query(centers.cpu(), xyz.cpu(), 0.02, 64))):
            raise AssertionError("learner B=8: FPS / ball-query indices differ card vs CPU")
        got = update(state, batch, noise_draws=draws)
        want = update_cpu(state_cpu, _cpu(batch), noise_draws=draws.cpu())
        if actor and float(want["actor_critic_loss"]) == 0.0:
            raise AssertionError("learner B=8: the actor term is not live")
        err = 0.0
        for k, w in want.items():
            torch.testing.assert_close(got[k].cpu(), w, rtol=1e-3, atol=1e-3, msg=k)
            err = max(err, (got[k].cpu() - w).abs().item())
        return err

    def scale2_card_vs_cpu(self, seeds=SCALE2_SEEDS):
        """The model_scale 2 agent on the card against the CPU, each batch
        from a generator of its own: `select_action` at B=8 (the launches
        of one call as at scale 1, K4 on its layer engine) within 1e-3; then
        for each of SCALE2_SEEDS one B=8 DDPG update from a common state
        (card_vs_cpu's first update; `seeds` sets which batches), within the
        scale 1 bounds. Beside each
        seed's card-vs-CPU moves it logs the plain version's own float32
        spread on the same batch: the CPU update run again with the point
        states nudged by one ulp (each float in a random direction), against
        the CPU update. Moves that differ come in discrete events (a ReLU or
        a max-pool argmax flipped by rounding, carried through the FC
        trunk's BatchNorm over 8 rows) that any perturbation of the batch
        may set off; the spread shows how large they come on these
        batches. Every seed runs; the phase fails after the last if any
        seed was off its bounds."""
        from gaddpg_tpu_torch.agents import make_select_action

        cfg, state, _ = self.scale2()
        gen = torch.Generator(device=self.device).manual_seed(SCALE2_SELECT_SEED)
        select, select_cpu = make_select_action(cfg), make_select_action(cfg, device="cpu")
        ps = synthetic_point_state(8, gen, self.hand_points, self.device)
        remain = torch.full((8,), 10.0, device=self.device)
        with torch.no_grad():
            self.reset_counts()
            action, aux = select(state, ps, remain)
            counts = self.counts()
            want = select_cpu(state.to("cpu"), ps.cpu(), remain.cpu())
        if counts != PER_CALL:
            raise AssertionError(f"scale 2 select_action: launches {counts}, expected {PER_CALL}")
        err = 0.0
        for name, got, w in (("action", action, want[0]), ("aux", aux, want[1])):
            if got.shape != w.shape or not torch.isfinite(got).all():
                raise AssertionError(f"scale 2 select_action: {name} shape/finite check failed")
            torch.testing.assert_close(got.cpu(), w, rtol=1e-3, atol=1e-3)
            err = max(err, (got.cpu() - w).abs().max().item())
        log(f"[main] select_action scale 2 B=8: launches {counts}, card vs CPU "
            f"max_abs_err={err:.3e} ok")

        cfg, update, update_cpu, start = self.b8_learner(SCALE2_FEATURE)
        worst, failed = {}, []
        log(f"[learner] scale 2: the CPU updates on {CROSSING_THREADS} threads (default "
            f"{torch.get_num_threads()})")
        for seed in seeds:
            batches, draws = self.scale2_batches(seed)
            with crossing_threads():
                state, before, state_cpu = self.scale2_start(update_cpu, start, batches, draws)
                err = self.b8_update(update, update_cpu, state, state_cpu, batches[1],
                                     draws[1], actor=True)
            try:  # update_step, counts, running statistics, BatchNorm-fed biases
                serr, offs = self.compare_updated(cfg, before, state, state_cpu, quiet=True,
                                                  moves=False)
            except AssertionError as e:
                failed.append(f"seed {seed}: {e}")
                serr, offs = float("nan"), move_offs(cfg, before, state, state_cpu)
            crossed = crossing_groups(offs)
            spreads = nudge_spreads(cfg, update_cpu, before, state_cpu, batches[1], draws[1],
                                    seed, NUDGES if crossed else 1)
            verdict = crossing_verdict(offs, spreads)
            if verdict:
                failed.append(f"seed {seed}: {verdict}")
            for group, (off, total, _) in offs.items():
                w = worst.setdefault(group, [0, 0, total])
                w[0], w[1] = max(w[0], off), max(w[1], spreads[0][group])
            log(f"[learner] scale 2 seed {seed}: metrics max_abs_err={err:.3e}, running "
                f"statistics max_abs_err={serr:.3e}; moves off, card vs CPU | one-ulp nudge "
                "vs CPU: " + ", ".join(f"{g} {o} | {spreads[0][g]} of {n} (bound {s})"
                                       for g, (o, n, s) in offs.items()))
            if crossed:
                log(f"[learner] scale 2 seed {seed}: {', '.join(crossed)} past the bound; "
                    f"{len(spreads)} one-ulp nudges of the CPU update move off " + "; ".join(
                        f"{g} {[sp[g] for sp in spreads]}" for g in crossed)
                    + (f": {verdict}" if verdict else ": the card's count is within "
                       f"{CROSSING_MATCH:.0%} of a nudge's that crosses too, the "
                       "reference's own event ok"))
        log(f"[learner] scale 2 over seeds {list(seeds)}: largest share of moves off, "
            "card vs CPU | one-ulp nudge vs CPU: " + ", ".join(
                f"{g} {c / n:.2e} | {s / n:.2e}" for g, (c, s, n) in worst.items()))
        if failed:
            raise AssertionError("scale 2 DDPG update, card vs CPU: " + "; ".join(failed))
        log(f"[learner] ddpg update B=8 scale 2, {len(seeds)} seeds: indices equal, "
            "metrics, running statistics and moves within bounds (or a crossing the "
            "reference's own one-ulp nudges give) ok")

    def scale2_batches(self, seed):
        """The two B=8 batches and smoothing draws of a seed, from a
        generator of its own."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        batches = [self.mixed_batch(8, gen) for _ in range(2)]
        draws = [torch.rand((8, 6), generator=gen, device=self.device) for _ in batches]
        return batches, draws

    def scale2_start(self, update_cpu, start, batches, draws):
        """The common state of a seed's compared update -> (its card copy,
        the CPU copy before the update, the CPU state to update)."""
        state_cpu = start.to("cpu")
        return (*self.b8_start(update_cpu, state_cpu, batches[0], draws[0]), state_cpu)

    def k5_scale_control(self, epsilons, seeds=SCALE2_SEEDS):
        """The check's sensitivity: the scale-2 update of each seed with
        K5's pooled output scaled by (1 + eps) on the card, for each eps,
        held by the rule of `scale2_card_vs_cpu` -> {eps: [seeds whose
        update the rule refuses]}. The nudges are the CPU's and are
        computed once per seed."""
        cfg, update, update_cpu, start = self.b8_learner(SCALE2_FEATURE)
        kernels = self.sa_train._sa_train_kernels
        refused = {eps: [] for eps in epsilons}
        try:
            for seed in seeds:
                batches, draws = self.scale2_batches(seed)
                spreads, notes = None, []
                for eps in epsilons:
                    with crossing_threads():
                        state, before, state_cpu = self.scale2_start(update_cpu, start,
                                                                     batches, draws)
                        update_cpu(state_cpu, _cpu(batches[1]), noise_draws=draws[1].cpu())
                    self.sa_train._sa_train_kernels = scaled_pooled(kernels, eps)
                    update(state, batches[1], noise_draws=draws[1])
                    self.sa_train._sa_train_kernels = kernels
                    offs = move_offs(cfg, before, state, state_cpu)
                    if crossing_groups(offs) and spreads is None:
                        spreads = nudge_spreads(cfg, update_cpu, before, state_cpu,
                                                batches[1], draws[1], seed)
                    verdict = crossing_verdict(offs, spreads or [])
                    if verdict:
                        refused[eps].append(seed)
                    notes.append(f"eps {eps:g}: " + ", ".join(
                        f"{g} {o}" for g, (o, _, _) in offs.items())
                        + (f" REFUSED ({verdict})" if verdict else " accepted"))
                log(f"[control] K5 pooled x (1 + eps), seed {seed}: " + "; ".join(notes))
        finally:
            self.sa_train._sa_train_kernels = kernels
        for eps, r in refused.items():
            log(f"[control] eps {eps:g}: the rule refuses {len(r)} of {len(seeds)} seeds {r}")
        return refused

    def compare_updated(self, cfg, before, state, state_cpu, quiet=False, moves=True):
        """The card's and the CPU's state after one update from `before`:
        update_step and optimizer counts equal, running statistics within
        1e-3, and every group's moves within `move_offs`' bounds (logged
        unless `quiet`). A Dense bias that feeds a BatchNorm has a gradient
        of 0 up to rounding: it may move either way, by at most Adam's
        largest second-step move, 1.0014 lr. With moves=False the moves
        are counted but not held (the caller holds them). Returns (the
        running statistics' largest difference, `move_offs`)."""
        if state.update_step != state_cpu.update_step or any(
                state.opt[k].count != o.count for k, o in state_cpu.opt.items()):
            raise AssertionError("learner B=8: update_step or optimizer counts differ")
        serr = 0.0
        for (name, b), (_, b_cpu) in zip(state.feat.named_buffers(),
                                         state_cpu.feat.named_buffers()):
            if b.is_floating_point():
                torch.testing.assert_close(b.cpu(), b_cpu, rtol=1e-3, atol=1e-3, msg=name)
                serr = max(serr, (b.cpu() - b_cpu).abs().max().item())
        bounds = _move_bounds(cfg)
        prev, got, want = (_learner_modules(s) for s in (before, state, state_cpu))
        for group, (lr, _, _) in bounds.items():
            for (name, p0), (_, p), (_, p_cpu) in zip(prev[group].named_parameters(),
                                                      got[group].named_parameters(),
                                                      want[group].named_parameters()):
                moved = max((p.detach().cpu() - p0).abs().max(), (p_cpu - p0).abs().max())
                if _bn_fed_bias(group, name) and moved > 1.0014 * lr * (1 + 1e-4):
                    raise AssertionError(f"learner B=8: {group} {name} moved more than lr")
        offs = move_offs(cfg, before, state, state_cpu)
        for group, (off, total, share) in offs.items():
            if not quiet:
                log(f"[learner]   {group}: {off} of {total} moves differ by more than "
                    f"{bounds[group][1]} lr (bound {share})")
            if moves and off > share * total:
                raise AssertionError(f"learner B=8: {group}: {off} of {total} moves differ")
        return serr, offs

    def time_train(self, label, kernel, args):
        """One train kernel's forward and its plain version (CUDA events)
        and the function's bound -> (ms, plain ms, bytes, flops)."""
        with torch.no_grad():
            ms = cuda_ms(lambda: self.wrappers[kernel](*args), reps=5, rounds=5)
            plain = cuda_ms(lambda: self.train_reference(kernel)(*args), reps=2, rounds=3)
        nbytes, flops = train_work(kernel, args)
        bms, by = bound_ms(nbytes, flops, kernel_peak(kernel))
        log(f"[time] {kernel:14s} {label:10s} B={args[0].shape[0]}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; {nbytes} B, {flops} FLOP)"
            + self.distinct_note(kernel, args))
        return ms, plain, nbytes, flops

    def cloud_timings(self, point_state):
        """K3 at B=ENV_BATCH and K5 at B=TRAIN_BATCH on the wrist-camera
        point states of the env path after its expert steps, then each on
        the worst case of its SA2 inputs (every slot computed), beside its
        plain version, distinct-row share and bounds (CUDA events). The
        synthetic batches of phases 5 and 6 have other distinct shares.
        Before, K1 and K2 on the same clouds (`check_fps`,
        `check_ball_query`)."""
        with torch.no_grad():
            env_clouds = point_state[:, :3, 6:].transpose(1, 2)
            self.check_fps(None, env_clouds)
            self.check_ball_query(None, env_clouds)
            calls = self.level_inputs(point_state[:ENV_BATCH])["sa_gather_mlp"]
            for label, args in calls:
                self.time_serving("sa_gather_mlp", f"{label} env", ENV_BATCH, args)
            idx, full, cpad, weights = calls[-1][1]
            worst = stress_groups(idx, full.shape[1])["all computed"]
            self.time_serving("sa_gather_mlp", "SA2 worst", ENV_BATCH, (worst, full, cpad, weights))
            calls = [c for c in self.train_level_inputs(point_state[:TRAIN_BATCH])
                     if c[1] == "sa_train"]
        for label, kernel, args in calls:
            self.time_train(f"{label} env", kernel, args)
        idx, full, cpad, dense = calls[-1][2]
        worst = stress_groups(idx, full.shape[1])["all computed"]
        self.time_train("policy SA2 worst", "sa_train", (worst, full, cpad, dense))

    def train_timings(self, gen):
        """K5/K6 per level at B=256 (kernel and plain forward, CUDA events)
        -> totals over one policy-encoder train forward; then K5 on
        bench.py's learner batch (N(0, 0.05) points: few distinct rows)."""
        totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}
                  for k in ("sa_train", "groupall_train")}
        for label, kernel, args in self.train_calls(TRAIN_BATCH, gen):
            ms, plain, nbytes, flops = self.time_train(label, kernel, args)
            if label.startswith("policy"):
                t = totals[kernel]
                t["ms"] += ms
                t["plain_ms"] += plain
                t["bytes"] += nbytes
                t["flops"] += flops
        # K5 on bench.py's learner batch, the one the updates train on
        with torch.no_grad():
            bench = self.train_level_inputs(self.learner_batch(TRAIN_BATCH, gen)["point_state"])
        for label, kernel, args in bench:
            if kernel == "sa_train":
                self.time_train(f"{label} bench", kernel, args)
        return totals

    def scale2_timings(self, gen):
        """The kernels the model_scale 2 agent runs at its wider widths,
        beside their plain versions and bounds (CUDA events): K3 and K4 (on
        the layer engine) in one serving forward at B=1024, K5 and K6 in
        one policy-encoder train forward at B=256. Not in the JSON line."""
        _, state, train_state = self.scale2()
        ps = synthetic_point_state(ENV_BATCH, gen, self.hand_points, self.device)
        with torch.no_grad():
            for kernel in ("sa_gather_mlp", "mlp_maxpool"):
                for label, args in self.level_inputs(ps, state)[kernel]:
                    self.time_serving(kernel, f"scale 2 {label}", ENV_BATCH, args)
        for label, kernel, args in self.train_calls(TRAIN_BATCH, gen, train_state):
            if label.startswith("policy"):
                self.time_train(f"scale 2 {label}", kernel, args)

    # -- phase 7: K7 against its plain version --------------------------------------
    def contact_rich_states(self, batch, gen):
        """tests/test_pallas_physics.py::make_states (a box and a cylinder
        at the closing gripper and on the table, the arm swinging joint 2,
        the fingers closing), tiled to `batch` with +-5 mm of seeded
        jitter in x and y after the first three."""
        from gaddpg_tpu_torch.envs.assets import AssetSpec, build_library
        from gaddpg_tpu_torch.physics import types
        from gaddpg_tpu_torch.robot import panda
        from gaddpg_tpu_torch.utils.constants import const

        lib = build_library([AssetSpec("box", "box", (0.05, 0.05, 0.10), 0.2),
                             AssetSpec("cyl", "cylinder", (0.033, 0.10), 0.35)]).to(self.device)
        d = self.device
        q = torch.cat([const(panda.DEFAULT_JOINTS, d), torch.tensor([0.04, 0.04], device=d)])
        qs = q.repeat(batch, 1)
        tgt = qs.clone()
        tgt[:, 1] += 0.08
        tgt[:, 7:] = 0.0
        base = torch.tensor([[0.55, 0.0, 0.0501], [0.50, 0.05, 0.0501], [0.58, -0.04, 0.0335]],
                            device=d)
        pos = base.repeat((batch + 2) // 3, 1)[:batch].clone()
        pos[3:, :2] += (torch.rand((max(batch - 3, 0), 2), generator=gen, device=d) - 0.5) * 0.01
        idx = torch.tensor([0, 1, 0], device=d).repeat((batch + 2) // 3)[:batch]
        state = types.PhysicsState(
            arm=types.ArmState(q=qs, qd=torch.zeros(batch, 7, device=d), q_target=tgt),
            obj=types.BodyState(pos=pos, quat=torch.tensor([1.0, 0, 0, 0], device=d).repeat(batch, 1),
                                linvel=torch.tensor([0.05, -0.02, 0.0], device=d).repeat(batch, 1),
                                angvel=torch.tensor([0.0, 0.0, 0.3], device=d).repeat(batch, 1)),
            contact_force=torch.zeros(batch, device=d),
            gripper_contact=torch.zeros(batch, dtype=torch.bool, device=d))
        return state, lib.spheres[idx], lib.mass[idx], lib.inertia[idx]

    def rollout_states(self, env, gen):
        """Physics states of a live env rollout at ENV_BATCH: a reset and 8
        expert steps, then the fingers set to close as a retract does."""
        state, _ = env.reset(ENV_BATCH, gen)
        for _ in range(8):
            state = env.step_batched(state, env.expert_action(state), gen)[0]
        phys = state.phys
        phys.arm.q_target = phys.arm.q_target.clone()
        phys.arm.q_target[:, 7:9] = 0.0
        idx = state.obj_idx
        return phys, env.lib.spheres[idx], env.lib.mass[idx], env.lib.inertia[idx]

    def scan_args(self, state, sph, mass, inertia, n):
        from gaddpg_tpu_torch.physics import fast
        from gaddpg_tpu_torch.physics.types import PhysicsParams

        p = PhysicsParams()
        _, _, hand = fast.hand_trajectory(p, state.arm, n)
        return p, [t.contiguous() for t in fast.pack_contact_scan(p, n, state, sph, mass,
                                                                   inertia, hand)]

    def nudged(self, s16, n):
        """A copy of the contact scan's state16 with its object position
        (over more than K7_JAX_SUBSTEPS substeps, every object float)
        moved by one ulp in seeded random directions."""
        s16 = s16.clone()
        cols = slice(0, 3) if n <= K7_JAX_SUBSTEPS else slice(0, 13)
        gen = torch.Generator(device=self.device).manual_seed(11)
        toward = s16[:, cols] + torch.randn(s16[:, cols].shape, generator=gen,
                                            device=self.device).sign()
        s16[:, cols] = torch.nextafter(s16[:, cols], toward)
        return s16

    def chaotic_spread(self, p, n, args, envs, want):
        """(len(envs), 16) largest move of the plain version's output over
        ULP_PROBES (over more than K7_JAX_SUBSTEPS substeps,
        ULP_PROBES_LONG) runs whose state is nudged by one ulp
        (`nudged`; one call, the probes stacked along the batch):
        how far float32 rounding alone moves each env's trajectory."""
        probes = ULP_PROBES if n <= K7_JAX_SUBSTEPS else ULP_PROBES_LONG
        # hand (n, B, 13) and sph3 (3, B, NS) carry the env batch second
        sub = [a[:, envs] if i in (1, 2) else a[envs] for i, a in enumerate(args)]
        reps = [t.repeat(1, probes, 1) if i in (1, 2) else
                t.repeat(probes, *([1] * (t.dim() - 1))) for i, t in enumerate(sub)]
        out = self.cs.contact_scan_reference(p, n, self.nudged(reps[0], n),
                                             *[t.contiguous() for t in reps[1:]])
        dev = (out.view(probes, len(envs), 16) - want[envs]).abs()
        return dev.amax(dim=0)

    def nudged_departure(self, p, n, args, want, tol):
        """What one one-ulp nudge of every state (`nudged`) does to the
        plain version: each env's departure in units of the bounds (B,),
        largest first, and how many envs it moves past the bounds (the
        batch's own chaotic count)."""
        out = self.cs.contact_scan_reference(p, n, self.nudged(args[0], n), *args[1:])
        r = ((out[:, :15] - want[:, :15]).abs() / tol[:15]).amax(dim=1)
        off = (r > 1) | (out[:, 15] != want[:, 15])
        return r.sort(descending=True).values, int(off.sum())

    def check_contact_scan(self, env, gen, kinds=None, cases=K7_CASES):
        """K7 against its plain version on the card. Where an env's
        trajectory is chaotic (a grasp at the edge of slipping: the plain
        version itself moves past the bounds when its object position is
        nudged by one ulp), the kernel's departure from the plain version,
        in units of the bounds, is held within CHAOS_FACTOR times the
        plain version's own one-ulp departure instead. Over more than
        K7_JAX_SUBSTEPS substeps each such env must be chaotic, and the
        k-th largest departure of the kernel's off envs must be within
        CHAOS_FACTOR times the k-th largest departure that one one-ulp
        nudge of every state gives the plain version on the same batch,
        for every k. At most CHAOTIC_SHARE of the envs of the largest
        batch at each n may be such, or over more than K7_JAX_SUBSTEPS
        substeps as many as that nudge moves past the bounds
        (`nudged_departure`). A smaller batch holds the first envs of the
        largest: its launch must give their rows bit for bit, and no more
        of its envs may be off the bounds than the largest batch excused
        (at B=64 one env is 1.6% of the batch, so the share is counted
        over the whole batch the envs come from), each held as above
        (rank by rank against the largest batch's nudge). `kinds`, [(label,
        (state, spheres, mass, inertia))], and `cases`, [(batch, substeps)],
        replace the contact-rich and live states of K7_CASES."""
        cs = self.cs
        if kinds is None:
            rich = self.contact_rich_states(max(b for b, _ in K7_CASES), gen)
            live = self.rollout_states(env, gen)
            self.k7_live = live
            kinds = (("contact-rich", rich), ("rollout", live))
        cases = sorted(cases, key=lambda c: (c[1], -c[0]))  # largest batch first
        for kind, full in kinds:
            # n -> (the largest batch's output, how many envs it excused, one
            # nudge's departures over that batch, largest first)
            largest = {}
            for batch, n in cases:
                state = dataclasses.replace(
                    full[0], arm=type(full[0].arm)(*(t[:batch] for t in (
                        full[0].arm.q, full[0].arm.qd, full[0].arm.q_target))),
                    obj=type(full[0].obj)(*(t[:batch] for t in (
                        full[0].obj.pos, full[0].obj.quat, full[0].obj.linvel, full[0].obj.angvel))))
                p, args = self.scan_args(state, *(t[:batch] for t in full[1:]), n)
                got = cs.contact_scan(p, n, *args)
                again = cs.contact_scan(p, n, *args)
                want = cs.contact_scan_reference(p, n, *args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K7 {kind} B={batch} n={n}: two launches differ")
                if n in largest and not torch.equal(got, largest[n][0][:batch]):
                    raise AssertionError(f"K7 {kind} B={batch} n={n}: differs from the same "
                                         f"envs in the B={len(largest[n][0])} launch")
                diff = (got - want).abs()
                tol = torch.zeros(16, device=self.device)
                for sl, t in K7_BOUNDS.values():
                    tol[sl] = t
                off = ((diff[:, :15] > tol[:15]).any(dim=1)
                       | (got[:, 15] != want[:, 15])).nonzero()[:, 0]
                note = ""
                nudge_r = None
                if len(off):
                    if n in largest:
                        nudge_r = largest[n][2]
                        if len(off) > largest[n][1]:
                            raise AssertionError(
                                f"K7 {kind} B={batch} n={n}: {len(off)} envs off the bounds, "
                                f"more than the {largest[n][1]} excused at B={len(largest[n][0])}")
                    else:
                        cap = CHAOTIC_SHARE * batch
                        if n > K7_JAX_SUBSTEPS:
                            nudge_r, nudge_off = self.nudged_departure(p, n, args, want, tol)
                            cap = max(cap, nudge_off)
                            note = f"; one one-ulp nudge moves {nudge_off} envs of the plain version"
                        if len(off) > cap:
                            raise AssertionError(
                                f"K7 {kind} B={batch} n={n}: {len(off)} envs off the bounds")
                    spread = self.chaotic_spread(p, n, args, off, want)
                    # departures in units of each field's bound
                    r_kernel = (diff[off, :15] / tol[:15]).amax(dim=1)
                    r_plain = (spread[:, :15] / tol[:15]).amax(dim=1)
                    flag_ok = (got[off, 15] == want[off, 15]) | (spread[:, 15] > 0)
                    if n > K7_JAX_SUBSTEPS:
                        # each env chaotic; the kernel's departures, largest
                        # first, within CHAOS_FACTOR of one nudge's, rank by rank
                        ranked = r_kernel.sort(descending=True).values
                        ratio = ranked / nudge_r[:len(off)].clamp(min=1e-30)
                        held = bool((r_plain > 1).all()) and bool(
                            (ranked <= CHAOS_FACTOR * nudge_r[:len(off)]).all())
                        note += (f"; largest departures, kernel {fmt_list(ranked[:5])}, one "
                                 f"nudge {fmt_list(nudge_r[:5])}, largest rank ratio "
                                 f"{ratio.max().item():.2f}")
                    else:
                        held = bool(((r_plain > 1) & (r_kernel <= CHAOS_FACTOR * r_plain)).all())
                    if not held or not flag_ok.all():
                        raise AssertionError(
                            f"K7 {kind} B={batch} n={n}: envs {off.tolist()}: kernel off by "
                            f"{r_kernel.tolist()} bounds, the plain version's one-ulp spread "
                            f"{r_plain.tolist()} bounds; one nudge, largest first: "
                            f"{fmt_list(nudge_r[:len(off)]) if nudge_r is not None else '-'}")
                    note += (f"; {len(off)} chaotic envs, kernel off by up to "
                            f"{r_kernel.max().item():.1f} bounds where one-ulp nudges move the "
                            f"plain version by up to {r_plain.max().item():.1f} (kernel/plain "
                            f"ratio at most {(r_kernel / r_plain).max().item():.2f})")
                    keep = torch.ones(batch, dtype=torch.bool, device=self.device)
                    keep[off] = False
                    diff = diff[keep]
                largest.setdefault(n, (got, len(off), nudge_r))
                errs = {name: diff[:, sl].max().item() for name, (sl, _) in K7_BOUNDS.items()}
                self.errors["contact_scan"] = max(self.errors["contact_scan"], *errs.values())
                log(f"[check] contact_scan   {kind:12s} B={batch:4d} n={n:3d}: "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f"{note}; gripper contact in {int(got[:, 15].sum())} envs; "
                    "two launches bit-identical ok")

    # -- phase 8: the env path ------------------------------------------------------
    def env_path(self, env, gen):
        """reset -> ENV_STEPS expert steps -> retract at ENV_BATCH, counting
        K7 launches call by call. Returns the state and the observation
        after the steps."""
        cs = self.cs
        total = 0

        def counted(name, expect, fn):
            nonlocal total
            self.reset_counts()
            out = fn()
            torch.cuda.synchronize()
            counts = self.counts()
            want = {k: 0 for k in counts}
            want["contact_scan"] = expect
            if counts != want:
                raise AssertionError(f"{name}: launches {counts}, expected {want}")
            total += counts["contact_scan"]
            return out

        state, obs = counted("reset", RESET_K7, lambda: env.reset(ENV_BATCH, gen))
        valid, reset_state = state.valid_scene, state
        for i in range(ENV_STEPS):
            state, obs, _, done, info = counted(
                f"step {i}", STEP_K7,
                lambda: env.step_batched(state, env.expert_action(state), gen))
        stepped, stepped_obs = state, obs
        if env.p.use_planner and not torch.equal(state.plan_step, torch.full_like(
                state.plan_step, ENV_STEPS)):
            raise AssertionError(f"env path: plan_step {state.plan_step.unique().tolist()} after "
                                 f"{ENV_STEPS} steps")
        state, lifted = counted("retract", RETRACT_K7, lambda: env.retract_batched(state))
        self.launches["contact_scan"] = total
        for name, t in (("pos", state.phys.obj.pos), ("quat", state.phys.obj.quat),
                        ("linvel", state.phys.obj.linvel), ("angvel", state.phys.obj.angvel),
                        ("q", state.phys.arm.q), ("point_state", obs.point_state),
                        ("goal_pose", obs.goal_pose)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"env path: non-finite {name}")
        # the ejection guard: an object above 1 m must be one the gripper
        # carries (touching it, its centre within HELD_RADIUS of the hand).
        # The expert can carry a light object up before the retract: a
        # collision freezes the goal in the object's frame
        # (grasp_env.py _update_goal), so the servo chases an object that
        # sits in its own fingers, as the JAX package does
        z = state.phys.obj.pos[:, 2]
        hand = env._hand(state)[:, :3, 3]
        held = state.phys.gripper_contact & (
            (state.phys.obj.pos - hand).norm(dim=-1) < HELD_RADIUS)
        if not ((z < 1.0) | held).all():
            raise AssertionError(f"env path: object ejected, max z {z[~held].max().item():.3f}")
        n_valid = int(valid.sum())
        if n_valid == 0:
            raise AssertionError("env path: no valid scene")
        rate = lifted[valid].mean().item()
        expert = "CHOMP planner" if env.p.use_planner else "goal-servo"
        log(f"[env] B={ENV_BATCH}, {expert} expert: plan_ok share after reset "
            f"{reset_state.plan_ok.float().mean().item():.4f} "
            f"({int(reset_state.plan_ok.sum())} of {ENV_BATCH}) ({self.card})")
        log(f"[env] B={ENV_BATCH}: reset launched K7 {RESET_K7}x, each of {ENV_STEPS} expert "
            f"steps 1x, retract {RETRACT_K7}x ({total} in all); valid scenes {n_valid} of "
            f"{ENV_BATCH}; lift rate over valid scenes {rate:.4f} "
            f"({int(lifted[valid].sum())} of {n_valid}); all values finite; max object z "
            f"{z.max().item():.4f}; done after {ENV_STEPS} steps in "
            f"{int(done.sum())} envs; mean points in view {obs.num_points.float().mean():.1f}; "
            f"{int((z >= 1.0).sum())} objects above 1 m, all carried in the gripper")
        self.env_reset_state = reset_state
        return stepped, stepped_obs

    def env_timings(self, env, gen, stepped):
        """Host-clock times of the env entry points at ENV_BATCH and K7's
        time against its plain version and bound. Returns K7's totals."""
        self.env_call_times(env, gen, stepped)
        return self.k7_timings()

    def env_call_times(self, env, gen, stepped):
        """step_batched (median of 7, bench.py's constant action, with its
        device profile), reset and retract_batched (one call each after a
        warm-up) at ENV_BATCH, host clock, synchronised."""
        d = self.device
        state, _ = env.reset(ENV_BATCH, gen)
        act = torch.tensor([0.0, 0.0, 0.02, 0.0, 0.0, 0.0], device=d).repeat(ENV_BATCH, 1)
        call = lambda: env.step_batched(state, act, gen)
        ms = host_ms(call, reps=7)
        log(f"[time] step_batched B={ENV_BATCH}: {ms:.3f} ms per step (host clock, synchronised, "
            f"median of 7 after a warm-up; bench.py's constant action), "
            f"{ENV_BATCH / ms * 1e3:.1f} env steps/s")
        busy, rows, _, launches = device_profile(call, calls=3, count=True)
        if busy == 0:
            log("[profile] step_batched: device time not measured "
                "(the profiler saw no device activity)")
        else:
            k7 = sum(t for name, t in rows if "contact_scan_kernel" in name)
            log(f"[profile] step_batched B={ENV_BATCH}: device busy {busy:.3f} ms per step, idle "
                f"share {max(0.0, 1 - busy / ms):.3f} of the host-clock step; K7 {k7:.3f} ms; "
                f"{launches:.0f} device activities per step of {len(rows)} kinds, "
                f"{ms / launches * 1e3:.1f} us of host time each")
            for name, t in rows[:8]:
                log(f"[profile]   {t:.4f} ms  {name[:100]}")
        reset_ms = host_ms(lambda: env.reset(ENV_BATCH, gen), reps=1)
        retract_ms = host_ms(lambda: env.retract_batched(stepped), reps=1)
        expert = "the CHOMP planner" if env.p.use_planner else "the goal servo"
        log(f"[time] reset B={ENV_BATCH} ({expert}): {reset_ms:.3f} ms; retract_batched "
            f"B={ENV_BATCH}: {retract_ms:.3f} ms (host clock, synchronised, one call after a "
            f"warm-up; {self.card})")

    def k7_timings(self):
        totals = None
        for batch, n in K7_TIMED:
            live = (map_state(self.k7_live[0], slice(0, batch)),
                    *(t[:batch] for t in self.k7_live[1:]))
            p, args = self.scan_args(*live, n)
            kms = cuda_ms(lambda: self.cs.contact_scan(p, n, *args), reps=5, rounds=5)
            plain = cuda_ms(lambda: self.cs.contact_scan_reference(p, n, *args), reps=1, rounds=3)
            nbytes, flops = contact_scan_work(args, n)
            bms, by = bound_ms(nbytes, flops)
            log(f"[time] contact_scan B={batch} n={n}: kernel {kms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bms:.6f} ms ({by}; {nbytes} B, {flops} FLOP); "
                f"{launches_note('contact_scan')}")
            if totals is None:
                totals = {"ms": kms, "plain_ms": plain, "bytes": nbytes, "flops": flops}
        return totals

    # -- phase 8: the CHOMP planner --------------------------------------------------------
    def plan_card_vs_cpu(self, env):
        """`plan_to_goal` on the card against the CPU at PLAN_BATCHES, on the
        planner inputs of phase 8's reset (ENV_BATCH envs of EnvParams(),
        seeded goals from the YCB proxy library), by `plan_rule`; the
        planner's host-clock time on both, and `replan`'s within a reset."""
        from gaddpg_tpu_torch.expert.chomp import plan_to_goal

        state = self.env_reset_state
        inputs = env.plan_inputs(state)
        cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in inputs.items()}
        t0 = time.perf_counter()
        plan_c, ok_c = plan_to_goal(**cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        nudge_gen = torch.Generator().manual_seed(19)
        for batch in PLAN_BATCHES:
            sub = {k: v[:batch] if torch.is_tensor(v) else v for k, v in inputs.items()}
            sub_c = {k: v[:batch] if torch.is_tensor(v) else v for k, v in cpu.items()}
            ms = host_ms(lambda: plan_to_goal(**sub), reps=3)
            plan_g, ok_g = (t.cpu() for t in plan_to_goal(**sub))

            def probe(envs, sub_c=sub_c):
                rep = {k: (one_ulp(v[envs].repeat(ULP_PROBES, *([1] * (v.dim() - 1))),
                                   nudge_gen) if torch.is_tensor(v) else v)
                       for k, v in sub_c.items()}
                plans, oks = plan_to_goal(**rep)
                return plans.view(ULP_PROBES, len(envs), *plans.shape[1:]), oks.view(
                    ULP_PROBES, -1)

            got = plan_rule(f"plan_to_goal B={batch}", plan_g, ok_g, plan_c[:batch],
                            ok_c[:batch], probe)
            agree = batch - got["n_chaotic"] - got["n_branch"] - got["n_left"]
            within = int(((plan_g - plan_c[:batch]).abs().amax(dim=(1, 2)) <= 1e-5).sum())
            log(f"[planner] plan_to_goal B={batch} card vs CPU: {agree} within "
                f"{PLAN_TOL_CARD:g} rad ({within} within 1e-5), {got['n_chaotic']} chaotic "
                f"(within {PLAN_CHAOS:g}x the CPU's one-ulp spread; first {got['chaotic']}), "
                f"{got['n_branch']} on another IK branch (reached pose within "
                f"{BRANCH_POSE_TOL:g} m; first {got['branch']}), {got['n_left']} left "
                f"(first {got['left']}); largest departure {got['largest']:.3g} rad; ok "
                f"share {ok_g.float().mean():.4f}, ok equal on "
                f"{int((ok_g == ok_c[:batch]).sum())}; card {ms:.3f} ms per call (host "
                f"clock, median of 3; {self.card}) ok")
        log(f"[planner] plan_to_goal B={ENV_BATCH} on the CPU: {cpu_ms:.1f} ms (host clock, "
            f"{torch.get_num_threads()} threads)")
        replan_ms = host_ms(lambda: env.replan(state), reps=3)
        log(f"[time] replan B={ENV_BATCH}: {replan_ms:.3f} ms (host clock, synchronised, median "
            f"of 3 after a warm-up; a reset runs it once per try; {self.card})")
        busy, rows, _, launches = device_profile(lambda: env.replan(state), calls=1, count=True)
        if busy:
            log(f"[profile] replan B={ENV_BATCH}: device busy {busy:.3f} ms, idle share "
                f"{max(0.0, 1 - busy / replan_ms):.3f}; {launches:.0f} device activities")
            for name, t in rows[:5]:
                log(f"[profile]   {t:.4f} ms  {name[:100]}")

    def seed_contract(self):
        """examples/minimal_rollout.py's contract in the port:
        `PandaGraspEnv(EnvParams())` (the CHOMP expert) on
        box_asset(0.05, 0.05, 0.14, mass=0.2), each seed's episode reset
        on the card from a CPU generator of that seed, up to ENV_STEPS
        expert steps (an env stops when done, as the example breaks), the
        retract: every object below z = 1.0 and every value finite. The
        CPU replans the card's reset states (`plan_rule`) and runs the
        episodes again from them: each seed's outcome as on the card, or
        flipped to it by a one-ulp nudge of the state (CONTRACT_SEEDS'
        comment). The CPU's own resets of the seeds are logged beside."""
        from gaddpg_tpu_torch.envs.assets import box_asset
        from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv, _where
        from gaddpg_tpu_torch.physics.types import map_tensors
        from gaddpg_tpu_torch.robot.panda import fk_hand

        lib = box_asset(0.05, 0.05, 0.14, mass=0.2)
        envs = {dev: PandaGraspEnv(EnvParams(), lib, device=dev) for dev in (self.device, "cpu")}
        env_c = envs["cpu"]

        def reset(env):
            return cat_states([env.reset(1, torch.Generator().manual_seed(s))[0]
                               for s in CONTRACT_SEEDS])

        def episode(env, state):
            """-> (lifted (B,) bool on the CPU, the retracted state)."""
            done = torch.zeros_like(state.done)
            gen = torch.Generator().manual_seed(0)
            for _ in range(ENV_STEPS):
                new, _, _, new_done, _ = env.step_batched(state, env.expert_action(state), gen)
                state = _where(~done, new, state)
                done = done | new_done
            state, lifted = env.retract_batched(state)
            z = state.phys.obj.pos[:, 2]
            if not ((z < 1.0).all() and torch.isfinite(state.phys.obj.pos).all()
                    and torch.isfinite(state.phys.arm.q).all()):
                raise AssertionError(f"minimal_rollout on {env.device}: object z {z.tolist()}")
            return (lifted > 0).cpu(), state

        def nudged(state, envs, gen):
            """ULP_PROBES copies of `state`'s envs, each nudged by one ulp."""
            return nudge_env_state(repeat_state(map_tensors(state, lambda t: t[envs]),
                                                ULP_PROBES), gen)

        t0 = time.perf_counter()
        start = reset(envs[self.device])
        card, end = episode(envs[self.device], start)
        z = end.phys.obj.pos[:, 2]
        log(f"[planner] minimal_rollout seeds {CONTRACT_SEEDS[0]}-{CONTRACT_SEEDS[-1]} on the "
            f"card: lifted {card.int().tolist()}, plan_ok {end.plan_ok.int().tolist()}, object z "
            f"{[round(v, 3) for v in z.tolist()]}; {int(card.sum())} of {len(CONTRACT_SEEDS)} "
            f"lift below 1 m (the JAX package: 6 of 8); {(time.perf_counter() - t0):.1f} s")
        t0 = time.perf_counter()
        start_g = start.to("cpu")
        # the card's reset plans against the CPU's from the same states
        gen = torch.Generator().manual_seed(29)

        def probe(envs):
            out = env_c.replan(nudged(start_g, envs, gen))
            return (out.plan.view(ULP_PROBES, len(envs), *out.plan.shape[1:]),
                    out.plan_ok.view(ULP_PROBES, -1))

        again = env_c.replan(start_g)
        plans = plan_rule("minimal_rollout reset plans", start_g.plan, start_g.plan_ok,
                          again.plan, again.plan_ok, probe)
        # the CPU's episodes from the card's reset states
        cpu, _ = episode(env_c, start_g)
        differ = (card != cpu).nonzero()[:, 0]
        if len(differ):
            probe_lift, _ = episode(env_c, nudged(start_g, differ, gen))
            reach = (probe_lift.view(ULP_PROBES, -1) == card[differ]).any(dim=0)
            if not reach.all():
                raise AssertionError(
                    f"minimal_rollout: seeds {differ[~reach].tolist()} lift "
                    f"{card[differ[~reach]].int().tolist()} on the card and "
                    f"{cpu[differ[~reach]].int().tolist()} on the CPU from the card's reset "
                    f"state, and none of {ULP_PROBES} one-ulp nudges of it flips the CPU's")
        log(f"[planner] minimal_rollout from the card's reset states on the CPU: plans within "
            f"plan_rule ({plans['n_chaotic']} chaotic, {plans['n_branch']} on another IK "
            f"branch, {plans['n_left']} left; largest departure {plans['largest']:.3g} rad); "
            f"lifted {cpu.int().tolist()} ({int(cpu.sum())} of {len(CONTRACT_SEEDS)}), "
            f"outcomes equal on {len(CONTRACT_SEEDS) - len(differ)} seeds, seeds "
            f"{differ.tolist()} flipped to the card's by a one-ulp nudge of the state; "
            f"{(time.perf_counter() - t0):.1f} s ok")
        # beside: the CPU's own resets of the same seeds
        start_c = reset(env_c)
        hand = (fk_hand(start_g.phys.arm.q[:, :7])[:, :3, 3]
                - fk_hand(start_c.phys.arm.q[:, :7])[:, :3, 3]).norm(dim=-1)
        joints = (start_g.phys.arm.q[:, :7] - start_c.phys.arm.q[:, :7]).abs().amax(dim=1)
        log(f"[planner] minimal_rollout resets card vs the CPU's own: hand positions "
            f"{[float(f'{x:.3g}') for x in hand.tolist()]} m apart, arm joints up to "
            f"{[float(f'{x:.3g}') for x in joints.tolist()]} rad apart per seed (another "
            f"solution of the same hand pose, or another reset try where the hands differ)")

    # -- compute_dtype="bfloat16" ----------------------------------------------------------
    def bf16_path(self, gen):
        """`AgentConfig(compute_dtype="bfloat16")` through the entry points:
        select_action at BF16_BATCHES (launches as in float32, host-clock
        times), DDPG and BC updates at TRAIN_BATCH x TRAIN_POINTS (one
        warm-up and TIMED_UPDATES timed, launches as in float32, finite
        metrics), then a B=8 DDPG update on the card against the CPU from a
        common state by tests/test_torch_bf16.py's rule."""
        from gaddpg_tpu_torch.agents import (
            AgentConfig, create_agent_state, make_bc_update, make_ddpg_update,
            make_select_action,
        )

        cfg = AgentConfig(compute_dtype="bfloat16")
        state = create_agent_state(cfg, generator=torch.Generator().manual_seed(0))
        select = make_select_action(cfg)
        for batch in BF16_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            remain = torch.full((batch,), 10.0, device=self.device)
            with torch.no_grad():
                self.reset_counts()
                action, _ = select(state, ps, remain)
                torch.cuda.synchronize()
                if self.counts() != PER_CALL or not torch.isfinite(action).all():
                    raise AssertionError(f"bf16 select_action B={batch}: launches "
                                         f"{self.counts()}")
                ms = host_ms(lambda: select(state, ps, remain), reps=20 if batch < 256 else 10)
            log(f"[time] bf16 select_action B={batch:4d}: {ms:.3f} ms per call (host clock, "
                f"synchronised), {ms / batch:.4f} ms per request ({self.card})")
        train_state = create_agent_state(cfg, TRAIN_POINTS,
                                         generator=torch.Generator().manual_seed(1))
        batch = self.learner_batch(TRAIN_BATCH, gen)
        ddpg, bc = make_ddpg_update(cfg), make_bc_update(cfg)
        for name, update, per in (("ddpg", lambda: ddpg(train_state, batch, gen), DDPG_PER_UPDATE),
                                  ("bc", lambda: bc(train_state, batch), BC_PER_UPDATE)):
            times = []
            for i in range(1 + TIMED_UPDATES):
                self.reset_counts()
                t0 = time.perf_counter()
                metrics = update()
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
                if self.counts() != per:
                    raise AssertionError(f"bf16 {name} update: launches {self.counts()}")
                bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
                if bad:
                    raise AssertionError(f"bf16 {name} update: non-finite metrics {bad}")
            log(f"[time] bf16 {name} update B={TRAIN_BATCH}x{TRAIN_POINTS}: median "
                f"{statistics.median(times):.3f} ms (host clock, synchronised; min "
                f"{min(times):.3f}, max {max(times):.3f}, n={len(times)}; {self.card})")
        for p in train_state.feat.parameters():
            if p.dtype != torch.float32:
                raise AssertionError("bf16: a parameter is not float32")
        self.bf16_card_vs_cpu(gen)

    def bf16_card_vs_cpu(self, gen):
        """One B=8 bfloat16 DDPG update on the card and on the CPU from a
        common state with carried Adam moments (the actor term on): each
        metric, and each parameter group's root-sum-square difference,
        within BF16_GAP_SHARE of the CPU's own bfloat16-against-float32
        gap or BF16_SPREAD_FACTOR times the CPU bfloat16 update's spread
        over BF16_NUDGES perturbations of the point states by BF16_NUDGE.
        The negative control: the card's update from the same state with
        the FC layers in float32 must be refused on some output."""
        from gaddpg_tpu_torch.agents.state import _optimizer_params

        _, update, update_cpu, state_cpu = self.b8_learner(self.cfg.feature_dim, "bfloat16")
        batches = [self.mixed_batch(8, gen) for _ in range(2)]
        draws = [torch.rand((8, 6), generator=gen, device=self.device) for _ in batches]
        state, start = self.b8_start(update_cpu, state_cpu, batches[0], draws[0])
        batch, nd = _cpu(batches[1]), draws[1].cpu()

        def run(upd, st, b):
            st = st.to("cpu")
            return st, {k: float(v) for k, v in upd(st, b, noise_draws=nd).items()}

        got = {k: float(v) for k, v in update(state, batches[1], noise_draws=draws[1]).items()}
        ref_state, ref = run(update_cpu, start, batch)
        # the same state and update with the encoders' FC layers in float32
        start32 = start.to("cpu")
        for enc in (start32.feat.encoder, start32.feat.value_encoder):
            enc.compute_dtype = torch.float32
        f32_state, f32 = run(update_cpu, start32, batch)
        nudge_gen = torch.Generator().manual_seed(23)

        def perturbed(ps):
            return ps * (1.0 + BF16_NUDGE * torch.randn(ps.shape, generator=nudge_gen).sign())

        nudged = [run(update_cpu, start, dict(batch, point_state=perturbed(batch["point_state"])))
                  for _ in range(BF16_NUDGES)]

        def within(label, err, gap, spread):
            bound = max(BF16_GAP_SHARE * gap, BF16_SPREAD_FACTOR * spread)
            return err <= bound, f"{label} {err:.3e} (bound {bound:.3e})"

        def check(label, err, gap, spread):
            ok, reading = within(label, err, gap, spread)
            if not ok:
                raise AssertionError(f"bf16 B=8 card vs CPU {reading}: bf16-f32 gap {gap:.3e}, "
                                     f"perturbed spread {spread:.3e}")
            return err / gap if gap else 0.0

        flat = lambda st: {n: torch.cat([t.detach().cpu().ravel() for t in ts])  # noqa: E731
                           for n, ts in _optimizer_params(st).items()}
        want, w32 = flat(ref_state), flat(f32_state)
        spreads = [flat(n[0]) for n in nudged]

        def hold(rule, metrics, after):
            """`rule` on each metric and each parameter group's root-sum-square
            difference of the card's update (`metrics`, state `after`)."""
            out = {k: rule(k, abs(metrics[k] - ref[k]), abs(ref[k] - f32[k]),
                           max(abs(n[1][k] - ref[k]) for n in nudged)) for k in ref}
            mine = flat(after)
            for g in want:
                out[g] = rule(g, (mine[g] - want[g]).norm().item(), (want[g] - w32[g]).norm().item(),
                              max((sp[g] - want[g]).norm().item() for sp in spreads))
            return out

        ratios = hold(check, got, state)
        log(f"[bf16] B=8 DDPG update card vs CPU within the rule; ratios to the CPU's own "
            f"bf16-f32 gap: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()) + " ok")
        # the negative control: the card's update from the same start with
        # the encoders' FC layers in float32 must be refused somewhere
        card32 = start.to(self.device)
        for enc in (card32.feat.encoder, card32.feat.value_encoder):
            enc.compute_dtype = torch.float32
        got32 = {k: float(v) for k, v in update(card32, batches[1], noise_draws=draws[1]).items()}
        control = hold(within, got32, card32)
        refused = [r for ok, r in control.values() if not ok]
        log(f"[bf16] negative control, the card's update in float32 against the CPU's bf16: "
            f"refused on {len(refused)} of {len(control)}: " + "; ".join(refused))
        if not refused:
            raise AssertionError("bf16 B=8: the rule passes a float32 update on the card: "
                                 + "; ".join(r for _, r in control.values()))

    # -- phase 9: the env on the card against the CPU --------------------------------------
    def env_card_vs_cpu(self, env, env_cpu):
        """8 scenes through reset_scene, 3 step_batched calls (each from the
        CPU's state) and retract_batched on both devices, with CPU
        generators in the same state on both sides. An env whose object
        is off the phase-7 bounds must be chaotic: the CPU path itself,
        run again with the object position nudged by one ulp, moves at
        least 1/CHAOS_FACTOR as far (in units of the bounds)."""
        from gaddpg_tpu_torch.physics.types import map_tensors

        b = 8
        scene = env_cpu.sample_scene(b, torch.Generator().manual_seed(3))
        gens = [torch.Generator().manual_seed(4) for _ in range(2)]
        card = lambda x: {k: v.to(self.device) for k, v in x.items()}
        nudge_gen = torch.Generator().manual_seed(13)
        rep = lambda t, envs: t[envs].repeat(ULP_PROBES, *([1] * (t.dim() - 1)))

        def nudge(pos):
            return one_ulp(pos, nudge_gen)

        def reset_probe(envs):
            sub = {k: rep(v, envs) for k, v in scene.items()}
            sub["obj_pos"] = nudge(sub["obj_pos"])
            return env_cpu.reset_scene(sub)[0]

        st_g, ob_g = env.reset_scene(card(scene), gens[0])
        st_c, ob_c = env_cpu.reset_scene(scene, gens[1])
        worst, chaotic = self.compare_env("reset", st_g, ob_g, st_c, ob_c, 1e-6, reset_probe)
        for i in range(3):
            prev, acts = st_c, env_cpu.expert_action(st_c)
            got = env.step_batched(prev.to(self.device), acts.to(self.device), gens[0])
            st_c, ob_c, _, done_c, _ = env_cpu.step_batched(prev, acts, gens[1])

            def step_probe(envs, prev=prev, acts=acts):
                sub = nudge_state(map_tensors(prev, lambda t: rep(t, envs)), nudge)
                return env_cpu.step_batched(sub, rep(acts, envs))[0]

            w, c = self.compare_env(f"step {i}", got[0], got[1], st_c, ob_c,
                                    2 * ARM_SERVO_QUANTUM, step_probe)
            worst, chaotic = max(worst, w), chaotic | c
        lift_g = env.retract_batched(st_c.to(self.device))[1].cpu()
        lift_c = env_cpu.retract_batched(st_c)[1]
        differ = (lift_g != lift_c).nonzero()[:, 0]
        if len(differ):
            probe = env_cpu.retract_batched(nudge_state(map_tensors(st_c, lambda t: rep(t, differ)),
                                                        nudge))[1]
            flips = (probe.view(ULP_PROBES, -1) != lift_c[differ]).any(dim=0)
            if not flips.all():
                raise AssertionError(f"env card vs CPU: lifts {lift_g.tolist()} vs "
                                     f"{lift_c.tolist()}, not from a chaotic grasp")
        log(f"[env] card vs CPU, 8 scenes: reset, 3 steps, retract agree; largest point-state "
            f"share without a match {worst:.4f} (bound {POINT_SHARE_BOUND}); chaotic envs "
            f"{chaotic.nonzero()[:, 0].tolist()}; lifts card {lift_g.tolist()}, CPU "
            f"{lift_c.tolist()} ({len(differ)} differ, each flipped by a one-ulp nudge) ok")

    def compare_env(self, label, st_g, ob_g, st_c, ob_c, arm_tol, probe, goal_ties=None):
        """Card against CPU after one env call: the target, the fingers and
        any clutter bodies within the phase-7 bounds (`env_ratio`), or
        chaotic. With `goal_ties` (phase 12: the grasp goal among clutter,
        the CPU env's `_update_goal`) the goal is held like the view: not on
        a chaotic env, and where it differs on another, the CPU's goal query
        from the card's own hand and object poses must give the card's goal
        (the arm differs by up to two servo quanta, which moves the hand
        across near-ties of the nearest-grasp query), or one of the CPU's
        one-ulp nudged runs must pick another goal too. Returns (largest
        point-state share without a match, the (B,) mask of chaotic envs)."""
        g = st_g.to("cpu")
        r_card = env_ratio(g, st_c)
        flags = lambda s: torch.stack([s.phys.gripper_contact, s.collided, s.done], dim=1)
        flag_off = (flags(g) != flags(st_c)).any(dim=1)
        goal_gap = lambda a, b: (a - b).abs().amax(dim=(-2, -1))  # noqa: E731
        goal_off = goal_gap(g.goal_obj, st_c.goal_obj) > 1e-4
        if goal_ties is None:
            goal_off &= False
        else:  # the CPU's goal query on the card's poses picks the card's goal
            goal_off &= goal_gap(goal_ties(g).goal_obj, g.goal_obj) > 1e-4
        off = (r_card > 1) | flag_off | goal_off
        chaotic = torch.zeros_like(off)
        spread_note = ""
        if off.any():
            envs = off.nonzero()[:, 0]
            probes = probe(envs)
            n = len(envs)
            ref = map_state(st_c, envs)
            r_plain = env_ratio(probes, repeat_state(ref, ULP_PROBES)).view(
                ULP_PROBES, n).amax(dim=0)
            flipped = (flags(probes).view(ULP_PROBES, n, 3) != flags(ref)).any(dim=(0, 2))
            goal_flip = (goal_gap(probes.goal_obj.view(ULP_PROBES, n, 4, 4), ref.goal_obj)
                         > 1e-4).any(dim=0)
            ok = ((r_card[envs] <= CHAOS_FACTOR * r_plain) & (r_plain > 1)) | (
                (r_card[envs] <= 1) & (flipped | goal_flip))
            ok &= ~flag_off[envs] | flipped
            ok &= ~goal_off[envs] | goal_flip | (r_plain > 1)
            if not ok.all():
                raise AssertionError(
                    f"env card vs CPU {label}: envs {envs.tolist()} off by {r_card[envs].tolist()} "
                    f"bounds (flags differ: {flag_off[envs].tolist()}, goals differ: "
                    f"{goal_off[envs].tolist()}); one-ulp nudges of the CPU path move them by "
                    f"{r_plain.tolist()} (flags flip: {flipped.tolist()}, goals flip: "
                    f"{goal_flip.tolist()})")
            chaotic[envs] = True
            spread_note = (f" (card off by {[round(x, 2) for x in r_card[envs].tolist()]} "
                           f"bounds, one-ulp spread of the CPU path "
                           f"{[round(x, 1) for x in r_plain.tolist()]})")
        keep = ~chaotic
        errs = {"object_and_fingers": r_card[keep].max().item() if keep.any() else 0.0}
        errs["arm_q"] = (g.phys.arm.q[:, :7] - st_c.phys.arm.q[:, :7]).abs().max().item()
        gap = goal_gap(g.goal_obj, st_c.goal_obj)
        # with goal_ties, the envs whose goal differs pass only as near-ties
        # (the CPU's query from the card's poses agrees) or chaotic
        if goal_ties is None:  # phases 9 and 11: every env's goal within the bound
            ties, held = torch.zeros_like(keep), torch.ones_like(keep)
        else:
            ties = (gap > 1e-4) & keep
            held = keep & ~ties
        errs["goal_obj"] = gap[held].max().item() if held.any() else 0.0
        if errs["arm_q"] > arm_tol or errs["goal_obj"] > 1e-4:
            raise AssertionError(f"env card vs CPU {label}: {errs}")
        if not torch.equal(g.valid_scene, st_c.valid_scene):
            raise AssertionError(f"env card vs CPU {label}: valid_scene differs")
        # a chaotic env's object sits elsewhere: its view is not compared
        n_g, n_c = ob_g.num_points.cpu()[keep], ob_c.num_points[keep]
        if not ((n_g - n_c).abs() <= 0.01 * n_c + 2).all():
            raise AssertionError(f"env card vs CPU {label}: points {n_g.tolist()} vs {n_c.tolist()}")
        # the card's sampled points against the CPU's reservoir, world frame
        hand = ob_g.ef_pose.cpu()
        pts = (ob_g.point_state.cpu()[:, :3, 6:].transpose(1, 2)
               @ hand[:, :3, :3].transpose(1, 2) + hand[:, None, :3, 3])
        nv = torch.clamp(st_c.pc.count, max=st_c.pc.points.shape[1])
        share = nn_miss_share(pts[keep], [r[:k] for r, k, h in zip(st_c.pc.points, nv, keep) if h])
        if share and max(share) > POINT_SHARE_BOUND:
            raise AssertionError(f"env card vs CPU {label}: point-state shares {share}")
        worst = max(share, default=0.0)
        log(f"[env] card vs CPU {label}: object and fingers within "
            f"{errs['object_and_fingers']:.3f} of the phase-7 bounds, arm q {errs['arm_q']:.2e}, "
            f"goal {errs['goal_obj']:.2e}; chaotic envs {chaotic.nonzero()[:, 0].tolist()}"
            f"{spread_note}; "
            + (f"goals on a near-tie {ties.nonzero()[:, 0].tolist()}; " if ties.any() else "")
            + f"points {n_g.tolist()} vs {n_c.tolist()}; unmatched share max {worst:.4f} ok")
        return worst, chaotic


    # -- phase 11: the online train loop ---------------------------------------------------
    def loop_path(self, lib=None, tag="loop", profile=True, warm=True):
        """One `Trainer` iteration at full width, as a user runs it: the
        default TrainConfig (batch 256 x 1030 points, 4 DDPG updates, a
        100,000-transition ring) at LOOP_ENVS envs with its own EnvParams()
        (the CHOMP planner expert) on the YCB proxy library: one
        `collect`, then one `train_iter`. The counters are set to 0 before
        each and read after: collect launches K1-K4 through select_action
        at every one of the horizon's steps and K7 through reset, steps and
        retract; train_iter K1, K2, K5, K6 through the four updates. A
        second iteration gives the times of record (the first pays for the
        first CUDA update and the allocations) and, with `profile`, its
        parts' profile; with warm=False the counted iteration gives them
        (phase 13: the card is warm from phase 11's iterations). `lib`
        replaces the YCB proxies and `tag` labels the lines. Returns {kernel: launches over the first iteration}; the
        Trainer and the first iteration's record stay in `self.loop_run`."""
        import tempfile

        from gaddpg_tpu_torch.envs.assets import library_from_index
        from gaddpg_tpu_torch.train import Trainer, load_config

        card = self.card
        cfg = load_config(overrides={"num_envs": LOOP_ENVS,
                                     "output_dir": tempfile.mkdtemp(prefix="loop_")},
                          policy="DDPG")
        if not cfg.env.use_planner:
            raise AssertionError(f"{tag}: TrainConfig()'s EnvParams() runs the CHOMP planner")
        t0 = time.perf_counter()
        tr = Trainer(cfg, lib=lib or library_from_index("ycb", "train"))  # device="cuda"
        torch.cuda.synchronize()
        log(f"[{tag}] Trainer on {tr.lib.num_objects} objects at {LOOP_ENVS} envs, batch "
            f"{cfg.batch_size} x {cfg.env.uniform_num_pts + 6} points, {cfg.updates_per_iter} updates per "
            f"train_iter, ring of {cfg.buffer_size}: replay {tr.buffer.nbytes} bytes on the "
            f"card ({tr.buffer.point_state.nbytes} of them point states); set up in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
        # the main path: the first iteration, counted
        self.reset_counts()
        first = self.timed_iteration(tr, counts=True)
        stats, collect_counts, metrics, train_counts = (first[k] for k in (
            "stats", "collect_counts", "metrics", "train_counts"))
        horizon = cfg.rollout_horizon
        want_collect = {k: PER_CALL[k] * horizon for k in self.wrappers}
        want_collect["contact_scan"] = RESET_K7 + STEP_K7 * horizon + RETRACT_K7
        want_train = {k: v * cfg.updates_per_iter for k, v in DDPG_PER_UPDATE.items()}
        if collect_counts != want_collect or train_counts != want_train:
            raise AssertionError(f"{tag}: launches {collect_counts} in collect, {train_counts} "
                                 f"in train_iter; expected {want_collect}, {want_train}")
        per_iter = {k: collect_counts[k] + train_counts[k] for k in self.wrappers}
        if min(per_iter.values()) == 0:
            raise AssertionError(f"{tag}: a kernel was not launched: {per_iter}")
        if stats["buffer_idx"] <= 0 or tr.update_step != cfg.updates_per_iter:
            raise AssertionError(f"{tag}: buffer_idx {stats['buffer_idx']}, update_step "
                                 f"{tr.update_step}")
        bad = [k for k, v in {**stats, **metrics}.items() if not np.isfinite(v)]
        if bad or not metrics:
            raise AssertionError(f"{tag}: non-finite or missing metrics {bad} {metrics}")
        log(f"[{tag}] launches per train iteration (collect + train_iter): {per_iter}; collect "
            f"{collect_counts}, train_iter {train_counts} ({card})")
        log(f"[{tag}] first iteration (cold: first CUDA update, allocations): collect "
            f"{first['collect_ms']:.3f} ms, train_iter {first['train_ms']:.3f} ms; buffer_idx "
            f"{stats['buffer_idx']}, update_step {tr.update_step}; metrics " + ", ".join(
                f"{k} {v:.5g}" for k, v in metrics.items()) + f" ({card})")
        # the second iteration, warm: the numbers of record
        it = self.timed_iteration(tr) if warm else first
        which = "second iteration" if warm else "the counted iteration"
        spans, collect_ms, train_ms, stats = it["spans"], it["collect_ms"], it["train_ms"], \
            it["stats"]
        steps = LOOP_ENVS * horizon
        log(f"[{tag}] collect: {collect_split(spans, collect_ms, horizon)} (host clock, "
            f"synchronised around each; {which}; {card})")
        log(f"[{tag}] collect: {steps} env steps ({LOOP_ENVS} envs x {horizon}), "
            f"{steps / collect_ms * 1e3:.1f} env steps/s; {it['inserted']} valid "
            f"transitions inserted, {it['inserted'] / collect_ms * 1e3:.1f}/s; "
            f"valid scenes {stats['valid_scene_frac']:.4f}, success "
            f"{stats['rollout_success']:.4f}, explore share {stats['explore_frac']:.4f} ({card})")
        log(f"[{tag}] train_iter: {train_ms:.3f} ms, {train_ms / cfg.updates_per_iter:.3f} ms per "
            f"update, update_step {tr.update_step}; iteration {collect_ms + train_ms:.3f} ms "
            f"({which}; {card})")
        self.loop_run = (tr, first)
        if profile:
            self.loop_profile(tr, it)
        return per_iter

    def timed_iteration(self, tr, counts=False):
        """One collect and one train_iter of `tr`, the collect's env calls
        and replay insert timed (host clock, synchronised around each), each
        call counted and the first call's arguments and output kept."""
        from gaddpg_tpu_torch import replay

        spans, active, calls, first, first_out = {}, [], {}, {}, {}

        def timed(name, fn):
            def call(*args, **kwargs):
                # a replan inside the reset is its planner, else a DAgger replan
                key = name if name != "plan" or "reset" in active else "dagger"
                calls[key] = calls.get(key, 0) + 1
                first.setdefault(key, (args, kwargs))
                torch.cuda.synchronize()
                active.append(key)
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                first_out.setdefault(key, out)
                torch.cuda.synchronize()
                active.pop()
                spans[key] = spans.get(key, 0.0) + (time.perf_counter() - t) * 1e3
                return out
            return call

        env = tr.env
        env.reset = timed("reset", env.reset)
        env.replan = timed("plan", env.replan)
        env.step_batched = timed("steps", env.step_batched)
        env.retract_batched = timed("retract", env.retract_batched)
        add_episodes = replay.add_episodes
        replay.add_episodes = timed("insert", add_episodes)
        out = {"spans": spans, "calls": calls, "first": first, "first_out": first_out}
        try:
            before = tr.buffer.total_env_step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["stats"] = tr.collect()
            torch.cuda.synchronize()
            out["collect_ms"] = (time.perf_counter() - t0) * 1e3
            out["inserted"] = tr.buffer.total_env_step - before
            if counts:
                out["collect_counts"] = self.counts()
                self.reset_counts()
            t0 = time.perf_counter()
            out["metrics"] = tr.train_iter()
            torch.cuda.synchronize()
            out["train_ms"] = (time.perf_counter() - t0) * 1e3
            if counts:
                out["train_counts"] = self.counts()
        finally:
            replay.add_episodes = add_episodes
            for name in ("reset", "replan", "step_batched", "retract_batched"):
                delattr(env, name)
        return out

    def loop_profile(self, tr, it, label="loop iteration", replan=False):
        """Device busy time and idle share of an iteration's parts, each
        profiled on its own (torch.profiler): one `step_batched` from the
        inputs of the first step of `it` (a `timed_iteration`), with
        `replan` one DAgger replan from the first one's inputs (phase 8
        profiles the reset's replan), and one DDPG update (its backward
        recompute range left out, as phase 6 does). Each part's busy time
        per call against its host time per call in `it`, then over the
        iteration's steps, replans and updates together. The reset and the
        retract are not profiled: a whole iteration's trace takes minutes to
        read (810 s for one td3_clutter iteration)."""
        t_wall = time.perf_counter()
        spans, calls, first = it["spans"], it["calls"], it["first"]
        parts = {"step": lambda: tr.env.step_batched(*first["steps"][0], **first["steps"][1])}
        host = {"step": (spans["steps"], calls["steps"])}
        if replan and "dagger" in first:
            parts["replan"] = lambda: tr.env.replan(*first["dagger"][0])
            host["replan"] = (spans["dagger"], calls["dagger"])
        cfg = tr.cfg
        host["update"] = (it["train_ms"], cfg.updates_per_iter)
        tr.cfg = dataclasses.replace(cfg, updates_per_iter=1)
        try:
            measured = {name: device_profile(fn, calls=1, count=True, host_ops=False)
                        for name, fn in parts.items()}
            measured["update"] = device_profile(tr.train_iter, calls=1, count=True,
                                                ranges=("sa_train.backward_recompute",))
        finally:
            tr.cfg = cfg
        if any(m[0] == 0 for m in measured.values()):
            log(f"[profile] {label}: device time not measured (the profiler saw no "
                f"device activity) ({self.card})")
            return
        busy = host_total = 0.0
        notes = []
        for name, (busy_1, rows, _, n) in measured.items():
            total_ms, count = host[name]
            per_call = total_ms / count
            busy += busy_1 * count
            host_total += total_ms
            notes.append(f"{name} busy {busy_1:.3f} ms of {per_call:.3f} ms per call (idle "
                         f"{max(0.0, 1 - busy_1 / per_call):.3f}, {n:.0f} device activities), "
                         f"x{count}")
            for key, ms in rows[:3]:
                log(f"[profile]   {name}: {ms:.3f} ms  {key[:100]}")
        log(f"[profile] {label} parts: " + "; ".join(notes) + f"; together {host_total:.3f} ms "
            f"of the iteration's host time ({host_total / (it['collect_ms'] + it['train_ms']):.3f}"
            f" of it): device busy {busy:.3f} ms, idle share "
            f"{max(0.0, 1 - busy / host_total):.3f}; the reset and the retract not profiled "
            f"({self.card})")
        log(f"[profile] {label}: profiled and read in {time.perf_counter() - t_wall:.1f} s")

    def same_indices(self, label, point_state):
        """FPS and ball-query indices of an SA1 call on the batch's clouds,
        equal on the card and on the CPU."""
        xyz = point_state[:, :3, 6:].transpose(1, 2).contiguous()
        idx = self.sampling.furthest_point_sampling(xyz, 32)
        centers = self.sampling.gather_points(xyz, idx)
        if not (torch.equal(idx.cpu(), self.sampling.furthest_point_sampling(xyz.cpu(), 32))
                and torch.equal(self.sampling.ball_query(centers, xyz, 0.02, 64).cpu(),
                                self.sampling.ball_query(centers.cpu(), xyz.cpu(), 0.02, 64))):
            raise AssertionError(f"{label}: FPS / ball-query indices differ card vs CPU")

    def loop_card_vs_cpu(self, planner=False):
        """One collect and one train_iter of a B=8 Trainer at the dryrun's
        env sizes (`__graft_entry__.py:146-152`) on the card and on the
        CPU, from CPU generators in the same state (the same draws on both
        sides): the rollout's flags, masks, episode lengths and lifts, the
        ring's episode_map, cursors and integer fields and the sampled
        indices exactly equal; every env step of the card's rollout within
        phase 9's rule against the CPU step from the same state and draws,
        the reset too (without a chaos allowance); then the train_iter,
        on a common ring and from a common state that carries Adam
        moments, within the scale 1 card-vs-CPU update rule (metrics and
        running statistics within 1e-3, moves within their bounds).

        With `planner`, the env runs the CHOMP expert and the rollout its
        DAgger replan: each reset try's plans and each DAgger replan of the
        card (the envs whose plan restarts at a step) are held to
        `plan_rule` against the CPU's `replan` from the same state; the
        train_iter, which the planner does not reach, is left to the
        servo run."""
        import tempfile

        from gaddpg_tpu_torch import replay
        from gaddpg_tpu_torch.envs.assets import box_asset
        from gaddpg_tpu_torch.envs.grasp_env import EnvParams
        from gaddpg_tpu_torch.physics.types import PhysicsParams, map_tensors
        from gaddpg_tpu_torch.render.camera import CameraParams
        from gaddpg_tpu_torch.robot.panda import fk_hand
        from gaddpg_tpu_torch.train import Trainer, load_config

        env_p = EnvParams(physics=PhysicsParams(substeps=10),
                          camera=CameraParams(width=32, height=32), uniform_num_pts=58,
                          pc_capacity=128, new_points_per_step=32, settle_substeps=20,
                          max_steps=3, reset_tries=2, retract_lift_steps=2,
                          use_planner=planner)
        b = 8
        label = "planner" if planner else "servo"
        cfg = dataclasses.replace(load_config(overrides={
            "num_envs": b, "max_steps": 3, "extend_steps": 1, "batch_size": b,
            "updates_per_iter": 1, "buffer_size": 64, "output_dir": tempfile.mkdtemp(
                prefix="loop8_"),
            # half the envs explore; DAgger, DART and the expert start reach
            # into the 4-step horizon, so that every mask is live
            "explore_ratio": 5.0, "explore_cap": 0.5, "dagger": True, "dagger_min_step": 0,
            "dart_min_step": 0, "dart_max_step": 4}, policy="DDPG"), env=env_p)
        lib = box_asset(0.06, 0.06, 0.14)
        trainers = (Trainer(cfg, lib=lib), Trainer(cfg, lib=lib, device="cpu"))
        for tr in trainers:
            tr.generator = torch.Generator().manual_seed(LOOP_SEED)
        g, c = trainers
        steps, retracts = [], []
        env_g = g.env

        def recorded(fn, log_to, gen_arg=None):
            """fn, recording each call's arguments, the state of its
            generator (argument `gen_arg`) before the call, and its output."""
            def call(*args, **kwargs):
                before = None if gen_arg is None else args[gen_arg].get_state()
                out = fn(*args, **kwargs)
                log_to.append((args, kwargs, before, out))
                return out
            return call

        scenes, resets = [], []
        env_g.step_batched = recorded(env_g.step_batched, steps, gen_arg=2)
        env_g.sample_scene = recorded(env_g.sample_scene, scenes, gen_arg=1)
        env_g.reset_scene = recorded(env_g.reset_scene, resets, gen_arg=1)
        env_g.retract_batched = recorded(env_g.retract_batched, retracts)
        rollouts = []
        for tr in trainers:
            rollout = tr.worker.rollout
            tr.worker.rollout = lambda *a, rollout=rollout, **k: rollouts.append(
                rollout(*a, **k)) or rollouts[-1]
        try:
            stats = [tr.collect() for tr in trainers]
        finally:
            for name in ("step_batched", "sample_scene", "reset_scene", "retract_batched"):
                delattr(env_g, name)
            for tr in trainers:
                del tr.worker.rollout
        (eps_g, valid_g, rew_g, st_g), (eps_c, valid_c, rew_c, st_c) = rollouts
        exact = {"valid": (valid_g, valid_c)}
        exact.update({k: (st_g[k], st_c[k]) for k in ("explore_env", "valid_scene",
                                                       "episode_len")})
        exact.update({k: (eps_g[k], eps_c[k]) for k in ("expert_flags", "perturb_flags",
                                                         "timestep", "target_idx")})
        exact.update({k: (getattr(g.buffer, k), getattr(c.buffer, k))
                      for k in ("episode_map", "expert_flags", "perturb_flags", "timestep",
                                "terminal", "grasp", "target_idx")})
        for k, (x, y) in exact.items():
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"loop B=8 {label}: {k} differs card vs CPU: {x.tolist()} "
                                     f"vs {y.tolist()}")
        cursors = [(tr.buffer.cur_idx, tr.buffer.filled, tr.buffer.total_env_step)
                   for tr in trainers]
        if cursors[0] != cursors[1] or cursors[0][0] == 0:
            raise AssertionError(f"loop B=8: ring cursors {cursors}")
        flags = eps_g["expert_flags"][valid_g]
        log(f"[loop] B=8 {label} collect card vs CPU: explore envs {st_g['explore_env'].tolist()}, "
            f"valid steps {int(valid_g.sum())} ({sorted(set(flags.tolist()))} expert flags), "
            f"episode lengths, flags, masks, episode_map and cursors {cursors[0]} equal ok")

        # the env path, call by call, against the CPU from the card's inputs
        env_c = c.env

        def cpu_gen(state):
            gen = torch.Generator()
            gen.set_state(state)
            return gen

        nudge_gen = torch.Generator().manual_seed(17)
        rep = lambda t, envs: t[envs].repeat(ULP_PROBES, *([1] * (t.dim() - 1)))  # noqa: E731

        def nudge(pos):
            return one_ulp(pos, nudge_gen)

        def replan_probe(state):
            """plan_rule's probe: the CPU's replan of `state`'s envs from
            ULP_PROBES one-ulp nudges of their planner inputs (the arm's
            joints, the object's pose)."""
            def probe(envs):
                out = env_c.replan(nudge_env_state(map_tensors(state, lambda t: rep(t, envs)),
                                                   nudge_gen))
                return (out.plan.view(ULP_PROBES, len(envs), *out.plan.shape[1:]),
                        out.plan_ok.view(ULP_PROBES, -1))
            return probe

        plans = {"chaotic": 0, "branch": 0, "left": 0, "replans": 0}

        def hold_plans(name, plan_g, ok_g, plan_c, ok_c, state_c):
            got = plan_rule(f"loop B=8 {name}", plan_g.cpu(), ok_g.cpu(), plan_c, ok_c,
                            replan_probe(state_c))
            for k in ("chaotic", "branch", "left"):
                plans[k] += got[f"n_{k}"]

        # each reset try: the scene from the same draws (its IK start may
        # reach the hand pose from another near-tied seed, ROADMAP.md Queue
        # 3 not fault (b): the hand pose within 1e-2, as
        # tests/test_torch_env.py holds it), then reset_scene of the card's
        # scene within phase 9's rule
        worst, chaotic = 0.0, torch.zeros(b, dtype=torch.bool)
        for r, ((_, _, gs, scene_g), (args, _, gr, (rs_g, ro_g))) in enumerate(
                zip(scenes, resets)):
            scene_c = env_c.sample_scene(b, cpu_gen(gs))
            hand_g, hand_c = (fk_hand(sc["joints"].cpu()) for sc in (scene_g, scene_c))
            for k in ("obj_idx", "ik_ok"):
                if not torch.equal(scene_g[k].cpu(), scene_c[k]):
                    raise AssertionError(f"loop B=8 reset try {r}: {k} differs card vs CPU")
            for k, x, y, tol in (("obj_pos", scene_g["obj_pos"], scene_c["obj_pos"], 1e-6),
                                 ("obj_quat", scene_g["obj_quat"], scene_c["obj_quat"], 1e-6),
                                 ("hand pose", hand_g, hand_c, 1e-2)):
                if (x.cpu() - y).abs().max() > tol:
                    raise AssertionError(f"loop B=8 reset try {r}: {k} differs card vs CPU "
                                         f"by {(x.cpu() - y).abs().max().item():.3e}")
            scene = {k: v.cpu() for k, v in args[0].items()}
            rs_c, ro_c = env_c.reset_scene(scene, cpu_gen(gr))

            def reset_probe(envs, scene=scene):
                sub = {k: rep(v, envs) for k, v in scene.items()}
                sub["obj_pos"] = nudge(sub["obj_pos"])
                return env_c.reset_scene(sub)[0]

            if planner:
                hold_plans(f"reset try {r}", rs_g.plan, rs_g.plan_ok, rs_c.plan, rs_c.plan_ok,
                           rs_c)
            w, ch = self.compare_env(f"loop {label} reset try {r}", rs_g, ro_g, rs_c, ro_c, 1e-6,
                                     reset_probe)
            worst, chaotic = max(worst, w), chaotic | ch
        for i, (args, kwargs, gstate, out) in enumerate(steps):
            prev, acts = args[0].to("cpu"), args[1].cpu()
            requery = kwargs["requery_goal"].cpu()
            redo = (prev.plan_step == 0).nonzero()[:, 0] if planner and i else []
            if len(redo):  # the card's DAgger replans at this step
                sub = map_tensors(prev, lambda t: t[redo])
                again = env_c.replan(sub)
                hold_plans(f"step {i} DAgger replan", prev.plan[redo], prev.plan_ok[redo],
                           again.plan, again.plan_ok, sub)
                plans["replans"] += len(redo)
            got = env_c.step_batched(prev, acts, cpu_gen(gstate), requery_goal=requery)

            def probe(envs, prev=prev, acts=acts, requery=requery):
                sub = nudge_state(map_tensors(prev, lambda t: rep(t, envs)), nudge)
                return env_c.step_batched(sub, rep(acts, envs), requery_goal=rep(requery, envs))[0]

            w, ch = self.compare_env(f"loop {label} step {i}", out[0], out[1], got[0], got[1],
                                     2 * ARM_SERVO_QUANTUM, probe)
            worst, chaotic = max(worst, w), chaotic | ch
        (args, _, _, (_, lift_g)), = retracts
        pre = args[0].to("cpu")
        lift_c = env_c.retract_batched(pre)[1]
        differ = (lift_g.cpu() != lift_c).nonzero()[:, 0]
        if len(differ):
            probe = env_c.retract_batched(nudge_state(map_tensors(pre, lambda t: rep(t, differ)),
                                                      nudge))[1]
            if not (probe.view(ULP_PROBES, -1) != lift_c[differ]).any(dim=0).all():
                raise AssertionError(f"loop B=8: lifts {lift_g.tolist()} vs {lift_c.tolist()}, "
                                     "not from a chaotic grasp")
        if not torch.equal(rew_g.cpu(), rew_c) and not len(differ):
            raise AssertionError("loop B=8: rollout rewards differ card vs CPU")
        log(f"[loop] B=8 {label} env path card vs CPU: {len(resets)} reset tries and "
            f"{len(steps)} steps each within phase 9's rule from the same state and draws "
            f"(chaotic envs {chaotic.nonzero()[:, 0].tolist()}, largest unmatched point share "
            f"{worst:.4f}); lifts card {lift_g.tolist()}, CPU {lift_c.tolist()} ok")
        if planner:
            if not plans["replans"]:
                raise AssertionError("loop B=8 planner: no DAgger replan on a live env")
            log(f"[loop] B=8 planner: reset plans and {plans['replans']} DAgger replans within "
                f"plan_rule ({plans['chaotic']} chaotic, {plans['branch']} on another IK branch, "
                f"{plans['left']} left) ok")
            return

        # sampling and one train_iter from a common ring and state
        ep_len = min(cfg.max_steps, 8)
        draw_gen = torch.Generator().manual_seed(LOOP_SEED + 1)
        idx = [replay.sample(c.buffer, b, ep_len, generator=draw_gen)["batch_idx"]
               for _ in range(2)]
        noise = [torch.rand((b, 6), generator=draw_gen) for _ in range(2)]
        for i in idx:
            got, want = (replay.sample(tr.buffer, b, ep_len, idx=i) for tr in trainers)
            for k in ("batch_idx", "expert_flags", "perturb_flags", "terminal", "time"):
                if not torch.equal(got[k].cpu(), want[k]):
                    raise AssertionError(f"loop B=8: sampled {k} differs card vs CPU")
        for k in replay.buffer.TENSOR_FIELDS:  # the common ring: the card's
            getattr(c.buffer, k).copy_(getattr(g.buffer, k).cpu())
        batch0 = replay.sample(c.buffer, b, ep_len, idx=idx[0])
        c.update(c.agent_state, batch0, noise_draws=noise[0])  # Adam moments to carry
        c.agent_state.update_step = 0  # the actor term on
        before = c.agent_state.to("cpu")
        g.agent_state = c.agent_state.to(self.device)
        self.same_indices("loop B=8 train_iter",
                          replay.sample(g.buffer, b, ep_len, idx=idx[1])["point_state"])
        draws = [{"idx": idx[1], "noise": noise[1]}]
        got, want = (tr.train_iter(draws=draws) for tr in trainers)
        if not got or want["actor_critic_loss"] == 0.0:
            raise AssertionError(f"loop B=8 train_iter: no update or no actor term: {want}")
        err = 0.0
        for k, w in want.items():
            if not abs(got[k] - w) <= 1e-3 + 1e-3 * abs(w):
                raise AssertionError(f"loop B=8 train_iter: {k} {got[k]} vs {w}")
            err = max(err, abs(got[k] - w))
        serr, offs = self.compare_updated(cfg.agent, before, g.agent_state, c.agent_state,
                                          quiet=True)
        log(f"[loop] B=8 train_iter card vs CPU: sampled indices equal, metrics max_abs_err "
            f"{err:.3e}, running statistics max_abs_err {serr:.3e}, moves off " + ", ".join(
                f"{grp} {o} of {n}" for grp, (o, n, _) in offs.items()) + " within bounds ok")

    # -- phase 12: dynamic clutter -------------------------------------------------------
    def clutter_path(self, profile=True):
        """One `Trainer` iteration of experiments/cfgs/td3_clutter.yaml at its
        own sizes, as a user runs it: 256 envs of EnvParams(num_clutter=2,
        use_planner=True) on the YCB proxy library, DAgger, 20 DDPG updates
        of 128 expert rows beside 128 on-policy rows x 1030 points, a
        500,000-transition ring beside a 100,000 on-policy one. The first
        iteration is counted: collect launches K1-K4 through select_action at
        every step and no K7 (physics/multi.py steps the clutter scenes);
        train_iter K1, K2, K5, K6 through the updates. The same iteration
        gives the times of record (host-bound: a second iteration reads
        within the spread of the first across hosts) and, with `profile`,
        its parts' profile (a step and an update; phase 8 profiles a
        replan). Returns {kernel: launches over the iteration}."""
        import tempfile

        from gaddpg_tpu_torch.envs.assets import library_from_index
        from gaddpg_tpu_torch.train import Trainer, load_config

        card = self.card
        cfg = load_config(CLUTTER_CFG, overrides={
            "output_dir": tempfile.mkdtemp(prefix="clutter_")})
        shape = (cfg.num_envs, cfg.env.num_clutter, cfg.env.use_planner, cfg.dagger,
                 cfg.batch_size, cfg.updates_per_iter, cfg.buffer_size, cfg.online_buffer_size)
        if shape != (256, 2, True, True, 128, 20, 500000, 100000):
            raise AssertionError(f"clutter: td3_clutter.yaml gives {shape}")
        t0 = time.perf_counter()
        tr = Trainer(cfg, lib=library_from_index("ycb", "train"))  # device="cuda"
        torch.cuda.synchronize()
        ring = tr.buffer.nbytes + tr.online_buffer.nbytes
        log(f"[clutter] Trainer(td3_clutter.yaml) at {cfg.num_envs} envs, {cfg.env.num_clutter} "
            f"clutter bodies, the CHOMP planner and DAgger, batch {cfg.batch_size} + "
            f"{int(cfg.batch_size * cfg.online_buffer_ratio)} on-policy x "
            f"{cfg.env.uniform_num_pts + 6} points, {cfg.updates_per_iter} updates per "
            f"train_iter, rings of {cfg.buffer_size} and {cfg.online_buffer_size}: replay "
            f"{ring} bytes on the card ({ring / (cfg.buffer_size + cfg.online_buffer_size):.0f} "
            f"a transition); set up in {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
        self.reset_counts()
        first = self.timed_iteration(tr, counts=True)
        stats, collect_counts, metrics, train_counts = (first[k] for k in (
            "stats", "collect_counts", "metrics", "train_counts"))
        horizon = cfg.rollout_horizon
        want_collect = {k: PER_CALL[k] * horizon for k in self.wrappers}
        want_train = {k: v * cfg.updates_per_iter for k, v in DDPG_PER_UPDATE.items()}
        if collect_counts != want_collect or train_counts != want_train:
            raise AssertionError(f"clutter: launches {collect_counts} in collect, "
                                 f"{train_counts} in train_iter; expected {want_collect}, "
                                 f"{want_train}")
        per_iter = {k: collect_counts[k] + train_counts[k] for k in self.wrappers}
        if stats["buffer_idx"] <= 0 or tr.online_buffer.cur_idx <= 0 or \
                tr.update_step != cfg.updates_per_iter:
            raise AssertionError(f"clutter: buffer_idx {stats['buffer_idx']}, on-policy "
                                 f"{tr.online_buffer.cur_idx}, update_step {tr.update_step}")
        bad = [k for k, v in {**stats, **metrics}.items() if not np.isfinite(v)]
        if bad or not metrics:
            raise AssertionError(f"clutter: non-finite or missing metrics {bad} {metrics}")
        log(f"[clutter] launches per train iteration (collect + train_iter): {per_iter}; "
            f"collect {collect_counts} (K7 0: physics/multi.py steps the clutter), train_iter "
            f"{train_counts} ({card})")
        log(f"[clutter] iteration: collect {first['collect_ms']:.3f} ms, "
            f"train_iter {first['train_ms']:.3f} ms; buffer_idx {stats['buffer_idx']}, "
            f"on-policy {tr.online_buffer.cur_idx}, update_step {tr.update_step}; metrics "
            + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()) + f" ({card})")
        it = first
        collect_ms, train_ms = it["collect_ms"], it["train_ms"]
        steps = cfg.num_envs * horizon
        log(f"[clutter] collect: {collect_split(it['spans'], collect_ms, horizon)} (host clock, "
            f"synchronised around each; the counted iteration; {card})")
        log(f"[clutter] collect: {steps} env steps ({cfg.num_envs} envs x {horizon}), "
            f"{steps / collect_ms * 1e3:.1f} env steps/s; {it['inserted']} valid transitions "
            f"inserted; valid scenes {stats['valid_scene_frac']:.4f}, success "
            f"{stats['rollout_success']:.4f}, collisions {stats['collide_frac']:.4f}, explore "
            f"share {stats['explore_frac']:.4f} ({card})")
        log(f"[clutter] train_iter: {train_ms:.3f} ms, {train_ms / cfg.updates_per_iter:.3f} ms "
            f"per update; iteration {collect_ms + train_ms:.3f} ms (the counted iteration; {card})")
        # phase 8 profiles a replan at B=1024; here a step and an update
        if profile:
            self.loop_profile(tr, it, label="clutter iteration")
        del tr
        torch.cuda.empty_cache()
        return per_iter

    def clutter_card_vs_cpu(self, lib):
        """The clutter path at B=8 on the card and on the CPU, EnvParams(
        num_clutter=2, use_planner=True), CPU generators in the same state
        on both sides: each of two reset tries' reset_scene from the CPU's
        scene, CLUTTER_CHECK_STEPS planner-expert steps (each from the CPU's state) and
        retract_batched within phase 9's env rule, the clutter bodies held
        with the target (`env_ratio`) and the grasp goal by `compare_env`'s
        `goal_ties`; the reset plans and a DAgger replan
        of every env before the steps of CLUTTER_REPLANS within phase 8's `plan_rule`
        against the CPU's replan of the same state (the card's reset state
        for the reset's; a verdict may differ where the CPU's own nudges flip
        it); then generate_scenes -> Trainer.evaluate(scenes=, expert=True)
        (4-step episodes) on both sides with the same valid flags, or a flag
        that differs where one-ulp nudges of the scene flip the CPU's own."""
        import tempfile

        from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv, _where
        from gaddpg_tpu_torch.envs.scenes import generate_scenes
        from gaddpg_tpu_torch.expert.chomp import plan_to_goal
        from gaddpg_tpu_torch.physics.types import map_tensors
        from gaddpg_tpu_torch.train import Trainer, load_config

        b = 8
        p = EnvParams(num_clutter=2, use_planner=True)
        env, env_c = PandaGraspEnv(p, lib), PandaGraspEnv(p, lib, device="cpu")
        gens = [torch.Generator().manual_seed(21) for _ in range(2)]
        nudge_gen = torch.Generator().manual_seed(23)
        rep = lambda t, envs: t[envs].repeat(ULP_PROBES, *([1] * (t.dim() - 1)))  # noqa: E731
        card = lambda x: {k: v.to(self.device) for k, v in x.items()}  # noqa: E731

        def nudge(pos):
            return one_ulp(pos, nudge_gen)

        plans = {"chaotic": 0, "branch": 0, "left": 0, "held": 0}

        def hold_plans(name, st_g, st_c):
            inputs = env_c.plan_inputs(st_c)

            def probe(envs):  # every planner input nudged, as phase 8's probe does
                sub = {k: (nudge(rep(v, envs)) if torch.is_tensor(v) else v)
                       for k, v in inputs.items()}
                plans, oks = plan_to_goal(**sub)
                return plans.view(ULP_PROBES, len(envs), *plans.shape[1:]), oks.view(
                    ULP_PROBES, -1)
            got = plan_rule(f"clutter B=8 {name}", st_g.plan.cpu(), st_g.plan_ok.cpu(),
                            st_c.plan, st_c.plan_ok, probe, ok_flips=True)
            for k in ("chaotic", "branch", "left"):
                plans[k] += got[f"n_{k}"]
            plans["held"] += b

        worst, chaotic = 0.0, torch.zeros(b, dtype=torch.bool)
        st_c = ob_c = None
        for r in range(p.reset_tries):
            scene = env_c.sample_scene(b, torch.Generator().manual_seed(30 + r))
            rs_g, ro_g = env.reset_scene(card(scene), gens[0])
            rs_c, ro_c = env_c.reset_scene(scene, gens[1])

            def reset_probe(envs, scene=scene):
                sub = {k: rep(v, envs) for k, v in scene.items()}
                sub["obj_pos"] = nudge(sub["obj_pos"])
                sub["clutter_pos"] = nudge(sub["clutter_pos"])
                return env_c.reset_scene(sub)[0]

            # the reset's plans against the CPU's planner from the card's own
            # reset state: a chaotic joint settle moves the planner's inputs
            # (the object and clutter poses), which compare_env holds
            hold_plans(f"reset try {r}", rs_g, env_c.replan(rs_g.to("cpu")))
            w, ch = self.compare_env(f"clutter reset try {r}", rs_g, ro_g, rs_c, ro_c, 1e-6,
                                     reset_probe, goal_ties=env_c._update_goal)
            worst, chaotic = max(worst, w), chaotic | ch
            if st_c is None:
                st_c, ob_c = rs_c, ro_c
            else:  # the first valid try per env, as `reset` keeps it
                keep = st_c.valid_scene
                st_c, ob_c = _where(keep, st_c, rs_c), _where(keep, ob_c, ro_c)
        if not st_c.valid_scene.any():
            raise AssertionError("clutter B=8: no valid scene")
        for i in range(CLUTTER_CHECK_STEPS):
            if i in CLUTTER_REPLANS:  # a DAgger replan of every env from its current state
                rp_g = env.replan(st_c.to(self.device))
                st_c = env_c.replan(st_c)
                hold_plans(f"step {i} replan", rp_g, st_c)
            prev, acts = st_c, env_c.expert_action(st_c)
            got = env.step_batched(prev.to(self.device), acts.to(self.device), gens[0])
            st_c, ob_c, _, _, _ = env_c.step_batched(prev, acts, gens[1])

            def step_probe(envs, prev=prev, acts=acts):
                sub = nudge_state(map_tensors(prev, lambda t: rep(t, envs)), nudge)
                return env_c.step_batched(sub, rep(acts, envs))[0]

            w, ch = self.compare_env(f"clutter step {i}", got[0], got[1], st_c, ob_c,
                                     2 * ARM_SERVO_QUANTUM, step_probe,
                                     goal_ties=env_c._update_goal)
            worst, chaotic = max(worst, w), chaotic | ch
        lift_g = env.retract_batched(st_c.to(self.device))[1].cpu()
        lift_c = env_c.retract_batched(st_c)[1]
        differ = (lift_g != lift_c).nonzero()[:, 0]
        if len(differ):
            probe = env_c.retract_batched(nudge_state(map_tensors(st_c, lambda t: rep(t, differ)),
                                                      nudge))[1]
            if not (probe.view(ULP_PROBES, -1) != lift_c[differ]).any(dim=0).all():
                raise AssertionError(f"clutter B=8: lifts {lift_g.tolist()} vs "
                                     f"{lift_c.tolist()}, not from a chaotic grasp")
        log(f"[clutter] B=8 card vs CPU: {p.reset_tries} reset tries, {CLUTTER_CHECK_STEPS} planner-expert "
            f"steps and retract_batched within phase 9's rule (target, fingers and clutter; "
            f"chaotic envs {chaotic.nonzero()[:, 0].tolist()}, largest unmatched point share "
            f"{worst:.4f}); {plans['held']} plans (the reset tries' and {len(CLUTTER_REPLANS)} DAgger "
            f"replans of every env) within plan_rule ({plans['chaotic']} chaotic, {plans['branch']} on "
            f"another IK branch, {plans['left']} left); valid {st_c.valid_scene.tolist()}; "
            f"lifts card {lift_g.tolist()}, CPU {lift_c.tolist()} ok")

        # a scene set, then the expert baseline on it through Trainer.evaluate
        sc = generate_scenes(env_c, b, generator=torch.Generator().manual_seed(40))
        # the flags are the reset's: 4-step episodes are enough to reach them
        cfg = load_config(CLUTTER_CFG, overrides={
            "num_remotes": b, "RL_MEMORY_SIZE": 64, "ONPOLICY_MEMORY_SIZE": 64,
            "max_steps": 3, "extend_steps": 1, "output_dir": tempfile.mkdtemp(prefix="clutter8_")})
        outs, rates = [], []
        for device in ("cuda", "cpu"):
            tr = Trainer(cfg, lib=lib, device=device)
            tr.generator = torch.Generator().manual_seed(41)
            evaluate_scenes = tr.worker.evaluate_scenes
            tr.worker.evaluate_scenes = lambda *a, f=evaluate_scenes, **k: outs.append(
                f(*a, **k)) or outs[-1]
            rates.append(tr.evaluate(episodes=1, scenes=sc, expert=True)[0])
        (out_g, out_c) = outs
        valid_g, valid_c = out_g["valid_scene"].cpu(), out_c["valid_scene"]
        differ = (valid_g != valid_c).nonzero()[:, 0]
        if len(differ):  # only where the CPU's own settle flips it under one-ulp nudges
            sub = {k: rep(torch.as_tensor(v), differ) for k, v in sc.items()}
            sub["obj_pos"], sub["clutter_pos"] = nudge(sub["obj_pos"]), nudge(sub["clutter_pos"])
            probe = env_c.reset_scene(sub)[0].valid_scene.view(ULP_PROBES, -1)
            if not (probe == valid_g[differ]).any(dim=0).all():
                raise AssertionError(f"clutter B=8 evaluate(scenes=, expert=True): valid flags "
                                     f"{valid_g.tolist()} vs {valid_c.tolist()}, not from a "
                                     f"chaotic settle")
        log(f"[clutter] generate_scenes -> Trainer.evaluate(scenes=, expert=True) at B=8: valid "
            f"flags card {valid_g.tolist()}, CPU {valid_c.tolist()} ({len(differ)} differ, each "
            f"flipped by a one-ulp nudge of the CPU's settle); expert success over "
            f"valid scenes card {rates[0]:.3f}, CPU {rates[1]:.3f}; successes card "
            f"{out_g['success'].tolist()}, CPU {out_c['success'].tolist()} ok")

    def multi_vs_fast(self, gen):
        """physics/multi.py with its clutter parked far away against
        physics/fast.py (K7) on the card: MULTI_FAST_BATCH contact-rich
        states (phase 7's) over K7_JAX_SUBSTEPS substeps, each env's target
        and fingers within the phase-7 bounds, or chaotic as phase 7 holds
        the kernel against its plain version (the plain contact scan's own
        one-ulp spread reaches it), at most CHAOTIC_SHARE of the batch; the
        arm within 1e-6, no clutter hit."""
        from gaddpg_tpu_torch.physics.fast import fast_physics_step
        from gaddpg_tpu_torch.physics.multi import multi_physics_step
        from gaddpg_tpu_torch.physics.types import BodyState, PhysicsParams

        b, n = MULTI_FAST_BATCH, K7_JAX_SUBSTEPS
        p = PhysicsParams()
        state, sph, mass, inertia = self.contact_rich_states(b, gen)
        d = self.device
        far = torch.tensor([[5.0, 5.0, 5.0], [-5.0, 5.0, 5.0]], device=d).expand(b, 2, 3)
        quat = torch.tensor([1.0, 0, 0, 0], device=d).expand(b, 2, 4)
        clutter = BodyState(pos=far.contiguous(), quat=quat.contiguous(),
                            linvel=torch.zeros(b, 2, 3, device=d),
                            angvel=torch.zeros(b, 2, 3, device=d))
        rep3 = lambda t: t[:, None].expand(b, 3, *t.shape[1:]).contiguous()  # noqa: E731
        # the contact-rich library has no coarse spheres of its own here: the
        # clutter is far, so the target's own sphere set stands in
        coarse = rep3(sph[:, :12])
        out_m, _, hit = multi_physics_step(p, state, rep3(sph), coarse, rep3(mass),
                                           rep3(inertia), clutter, substeps=n)
        self.reset_counts()
        out_f = fast_physics_step(p, state, sph, mass, inertia, substeps=n)
        torch.cuda.synchronize()
        if self.counts()["contact_scan"] != 1:
            raise AssertionError("multi vs fast: fast_physics_step did not launch K7")
        r = physics_ratio(out_m, out_f)
        off = ((r > 1) | (out_m.gripper_contact != out_f.gripper_contact)).nonzero()[:, 0]
        note = ""
        if len(off):
            if len(off) > CHAOTIC_SHARE * b:
                raise AssertionError(f"multi vs fast: {len(off)} of {b} envs off the bounds")
            pp, args = self.scan_args(state, sph, mass, inertia, n)
            want = self.cs.contact_scan_reference(pp, n, *args)
            spread = self.chaotic_spread(pp, n, args, off, want)
            tol = torch.zeros(16, device=d)
            for sl, t in K7_BOUNDS.values():
                tol[sl] = t
            r_plain = (spread[:, :15] / tol[:15]).amax(dim=1)
            if not ((r_plain > 1) & (r[off] <= CHAOS_FACTOR * r_plain)).all():
                raise AssertionError(f"multi vs fast: envs {off.tolist()} off by "
                                     f"{r[off].tolist()} bounds, the plain scan's one-ulp "
                                     f"spread {r_plain.tolist()}")
            note = (f"; {len(off)} chaotic envs off by up to {r[off].max().item():.1f} bounds "
                    f"where one-ulp nudges move the plain scan by up to "
                    f"{r_plain.max().item():.1f}")
        keep = torch.ones(b, dtype=torch.bool, device=d)
        keep[off] = False
        arm = (out_m.arm.q - out_f.arm.q).abs().max().item()
        if arm > 1e-6 or hit.any():
            raise AssertionError(f"multi vs fast: arm off by {arm}, clutter hits {hit.sum()}")
        log(f"[check] multi_physics_step (far clutter) vs fast_physics_step (K7) B={b} n={n}: "
            f"within {r[keep].max().item():.3f} of the phase-7 bounds, arm {arm:.1e}{note}; "
            f"gripper contact in {int(out_f.gripper_contact.sum())} envs ok")

    # -- phase 13: the procedural library and the GoalFeature trainer -------------
    def proc_library(self, build):
        """The library of `build` (a `LibraryBuild` of PROC_INDEX, started
        at the run's start), as a user's `library_from_index(PROC_INDEX)`
        builds it on the CPU (the mesh pipeline and its physics-verified
        grasps are host work): its seconds, each object's grasp and sphere
        counts."""
        lib, info = build.result()
        grasps = lib.grasp_valid.sum(dim=1).tolist()
        spheres = (lib.spheres[..., 3] > 0).sum(dim=1).tolist()
        if lib.num_objects != PROC_OBJECTS or min(grasps) == 0 or min(spheres) == 0:
            raise AssertionError(f"proc: {lib.num_objects} objects, grasps {grasps}, spheres "
                                 f"{spheres}")
        secs = info["seconds"]
        log(f"[proc] library_from_index({PROC_INDEX!r}) on the CPU: {lib.num_objects} objects "
            f"{lib.names} in {secs:.1f} s ({secs / lib.num_objects:.1f} s per object, the host's "
            f"CPU, {info['where']}); verified grasps {grasps}, spheres {spheres}; native mesh "
            f"library (native/libmesh_tools.so) available: {info['native']}")
        return lib

    def proc_kernels(self, tr, first, gen):
        """K7 at B = PROC_K7_BATCH, n = 75, on the first envs of the
        procedural iteration's reset (mesh sphere sets, padding spheres
        parked at z = 1e3), the fingers closing, under phase 7's rule; K1
        and K2 on that reset's clouds (`check_fps`, `check_ball_query`) and
        K3 and K4 at phase 2's bounds on its point states."""
        state, obs = first["first_out"]["reset"]
        b = PROC_K7_BATCH
        phys = state.phys
        q_target = phys.arm.q_target[:b].clone()
        q_target[:, 7:9] = 0.0
        sub = dataclasses.replace(
            phys, arm=type(phys.arm)(q=phys.arm.q[:b], qd=phys.arm.qd[:b], q_target=q_target),
            obj=type(phys.obj)(*(t[:b] for t in (phys.obj.pos, phys.obj.quat, phys.obj.linvel,
                                                 phys.obj.angvel))),
            contact_force=phys.contact_force[:b], gripper_contact=phys.gripper_contact[:b])
        idx = state.obj_idx[:b]
        lib = tr.env.lib
        parked = (lib.spheres[idx, :, 3] == 0).sum().item()
        self.check_contact_scan(None, gen, kinds=(("proc reset", (
            sub, lib.spheres[idx], lib.mass[idx], lib.inertia[idx])),), cases=((b, 75),))
        log(f"[proc] K7 on the procedural reset's scenes: B={b}, {parked} padding spheres "
            f"parked among {b * lib.spheres.shape[1]} ok")
        ps = obs.point_state
        with torch.no_grad():
            clouds = ps[:, :3, 6:].transpose(1, 2)
            self.check_fps(None, clouds)
            self.check_ball_query(None, clouds)
            for kernel, level in self.level_inputs(ps).items():
                if kernel in ("sa_gather_mlp", "mlp_maxpool"):
                    for label, args in level:
                        self.check_call(kernel, f"proc reset {label}", args)

    def goal_train(self, lib):
        """`cli.train_goal.main` at its defaults (batch 32, 512-point clouds,
        a 64 x 64 camera) on the procedural library for GOAL_STEPS steps,
        as a user runs it, the counters set to 0 before and read after:
        each update launches K1 2x, K2 2x, K5 2x and K6 1x (the train
        forward; the backward is the plain recompute). Losses finite; ms per
        step (sample + update, host clock) and per update on one batch."""
        import tempfile

        from gaddpg_tpu_torch.cli import train_goal

        log_dir = tempfile.mkdtemp(prefix="goal_")
        self.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_goal.main(["--steps", str(GOAL_STEPS), "--log_dir", log_dir], lib=lib)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = self.counts()
        per_update = {k: v / GOAL_STEPS for k, v in counts.items()}
        if counts != {k: v * GOAL_STEPS for k, v in GOAL_PER_UPDATE.items()}:
            raise AssertionError(f"goal: launches {counts} over {GOAL_STEPS} steps, expected "
                                 f"{GOAL_PER_UPDATE} per update")
        losses = [(m["pm_loss"], m["bce_loss"]) for m in out["metrics"]]
        if len(losses) != GOAL_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"goal: losses {losses}")
        if not os.path.exists(out["path"]):
            raise AssertionError(f"goal: {out['path']} not written")
        log(f"[goal] cli.train_goal.main: {GOAL_STEPS} steps at batch 32 in {secs:.3f} s "
            f"({secs / GOAL_STEPS * 1e3:.3f} ms per step, sample + update, host clock, the "
            f"library built; {self.card}); launches per update {per_update}; pm_loss "
            f"{losses[0][0]:.4f} -> {losses[-1][0]:.4f}, bce_loss {losses[0][1]:.4f} -> "
            f"{losses[-1][1]:.4f}, all finite; saved {os.path.basename(out['path'])}")
        self.per_goal_update = per_update

    def goal_card_vs_cpu(self, lib):
        """The generator at batch GOAL_CHECK_BATCH on the card against the
        CPU on the same draws (rule (c): at most 3% of a cloud's points
        without a point of the other's within 1e-4, counts within 1% + 2;
        grasps within 1e-5 up to the quaternion's sign, labels and objects
        equal); K1, K2, K5 and K6 against their plain versions at the
        GoalFeature's shapes on the generator's clouds (zero rows included:
        FPS ties, repeated slots), K5 and K6 timed; then one GoalFeature
        update on the card against the CPU from a common state with
        carried Adam moments, under phase 6's update rule."""
        from gaddpg_tpu_torch.agents.optim import AdamW
        from gaddpg_tpu_torch.agents.state import goal_parameters, init_goal_
        from gaddpg_tpu_torch.data.grasp_dataset import (
            GraspDatasetGenerator, make_goal_feature_update,
        )
        from gaddpg_tpu_torch.models import GoalFeature

        gen_card, gen_cpu = GraspDatasetGenerator(lib), GraspDatasetGenerator(lib, device="cpu")
        goal_cpu = init_goal_(GoalFeature(), torch.Generator().manual_seed(5))
        opt_cpu = AdamW(goal_parameters(goal_cpu), GOAL_LR, eps=1e-5, weight_decay=1e-5)
        update_cpu = make_goal_feature_update(goal_cpu, opt_cpu)
        with torch.no_grad():
            draws = gen_cpu.draws(torch.Generator().manual_seed(3), GOAL_CHECK_BATCH)
            got, want = gen_card.from_draws(draws), gen_cpu.from_draws(draws)
            for k in ("obj_idx", "label"):
                if not torch.equal(got[k].cpu(), want[k]):
                    raise AssertionError(f"goal generator: {k} differs card vs CPU")
            g, w = got["grasp"].cpu(), want["grasp"]
            dq = torch.minimum((g[:, :4] - w[:, :4]).abs().amax(1),
                               (g[:, :4] + w[:, :4]).abs().amax(1)).max().item()
            dt = (g[:, 4:] - w[:, 4:]).abs().max().item()
            if dq > 1e-5 or dt > 1e-5:
                raise AssertionError(f"goal generator: grasps off by {dq:.3e} / {dt:.3e}")
            valid, valid_c = got["cloud_valid"].cpu(), want["cloud_valid"]
            n, n_c = valid.sum(1), valid_c.sum(1)
            if ((n - n_c).abs() > 0.01 * n_c + 2).any():
                raise AssertionError(f"goal generator: valid counts {n.tolist()} vs "
                                     f"{n_c.tolist()}")
            cloud, cloud_c = got["cloud"].cpu(), want["cloud"]
            miss = max(max(nn_miss_share([cloud[b][valid[b]]], [cloud_c[b][valid_c[b]]]) +
                           nn_miss_share([cloud_c[b][valid_c[b]]], [cloud[b][valid[b]]]))
                       for b in range(GOAL_CHECK_BATCH))
            if miss > CHAOTIC_SHARE:
                raise AssertionError(f"goal generator: {miss:.3f} of a cloud unmatched")
            log(f"[goal] GraspDatasetGenerator B={GOAL_CHECK_BATCH} card vs CPU on the same "
                f"draws: objects and labels equal, grasps within {max(dq, dt):.2e}, valid "
                f"points {int(n.sum())} vs {int(n_c.sum())} (mean {n.float().mean():.1f} of 512 "
                f"a cloud, the rest zero rows), largest unmatched share {miss:.4f} ok")
        clouds = gen_card.from_draws(gen_cpu.draws(torch.Generator().manual_seed(4),
                                                   GOAL_BATCH))["cloud"]
        goal_card = copy.deepcopy(goal_cpu).to(self.device)
        for label, kernel, args in self.goal_level_inputs(goal_card, clouds):
            if kernel in ("fps", "ball_query"):
                with torch.no_grad():
                    a, b2 = self.wrappers[kernel](*args), self.wrappers[kernel](*args)
                    want_i = self.reference(kernel)(*args)
                if not (torch.equal(a, want_i) and torch.equal(a, b2)):
                    raise AssertionError(f"{kernel} {label}: indices differ from the plain "
                                         "version or between two launches")
                log(f"[check] {kernel:14s} {label:10s} B={GOAL_BATCH}: indices equal, two "
                    "launches bit-identical ok")
            else:
                self.check_train_call(label, kernel, args, GOAL_BATCH)
                self.time_train(label, kernel, args)
        # one update from a common state: a CPU update first (moments to carry)
        batches = [gen_cpu.sample(torch.Generator().manual_seed(s), GOAL_BATCH) for s in (6, 7)]
        update_cpu(batches[0])
        goal_card = copy.deepcopy(goal_cpu).to(self.device)
        opt_card = AdamW(goal_parameters(goal_card), GOAL_LR, eps=1e-5, weight_decay=1e-5)
        for dst, src in zip(opt_card.mu + opt_card.nu, opt_cpu.mu + opt_cpu.nu):
            dst.copy_(src)
        opt_card.count = opt_cpu.count
        before = copy.deepcopy(goal_cpu)
        got = make_goal_feature_update(goal_card, opt_card)(
            {k: v.to(self.device) for k, v in batches[1].items()})
        want = update_cpu(batches[1])
        err = 0.0
        for k, w in want.items():
            torch.testing.assert_close(got[k].cpu(), w, rtol=1e-3, atol=1e-3, msg=k)
            err = max(err, (got[k].cpu() - w).abs().item())
        serr = 0.0
        for (name, b_), (_, b_cpu) in zip(goal_card.named_buffers(), goal_cpu.named_buffers()):
            if b_.is_floating_point():
                torch.testing.assert_close(b_.cpu(), b_cpu, rtol=1e-3, atol=1e-3, msg=name)
                serr = max(serr, (b_.cpu() - b_cpu).abs().max().item())
        lr, threshold, share = GOAL_LR, *_move_bounds(self.cfg)["encoder"][1:]
        off = total = 0
        for (name, p0), (_, p), (_, q) in zip(before.named_parameters(),
                                              goal_card.named_parameters(),
                                              goal_cpu.named_parameters()):
            moved, moved_cpu = (p.detach().cpu() - p0).double(), (q.detach() - p0).double()
            if name.startswith("encoder.") and _bn_fed_bias("encoder", name[len("encoder."):]):
                if max(moved.abs().max().item(), moved_cpu.abs().max().item()) > 1.0014 * lr:
                    raise AssertionError(f"goal update: {name} moved past 1.0014 lr")
                continue
            off += int(((moved - moved_cpu).abs() > threshold * lr).sum())
            total += p.numel()
        if off > share * total:
            raise AssertionError(f"goal update: {off} of {total} moves differ by more than "
                                 f"{threshold} lr (bound {share:.0%})")
        log(f"[goal] GoalFeature update B={GOAL_BATCH} card vs CPU from a common state: losses "
            f"max_abs_err={err:.3e}, running statistics max_abs_err={serr:.3e}, {off} of {total} "
            f"moves off by more than {threshold} lr (bound {share:.0%}) ok")
        # the update and the generator alone: host clock, synchronised
        update = make_goal_feature_update(goal_card, opt_card)
        batch = {k: v.to(self.device) for k, v in batches[1].items()}
        draw = torch.Generator(device=self.device).manual_seed(8)
        upd_ms = host_ms(lambda: update(batch), reps=5)
        gen_ms = host_ms(lambda: gen_card.sample(draw, GOAL_BATCH), reps=5)
        busy, rows, _, n = device_profile(lambda: update(batch), calls=1, count=True,
                                          host_ops=False,
                                          ranges=("sa_train.backward_recompute",))
        log(f"[goal] GoalFeature update B={GOAL_BATCH}: {upd_ms:.3f} ms (median of 5), device "
            f"busy {busy:.3f} ms (idle {max(0.0, 1 - busy / upd_ms):.3f}, {n:.0f} device "
            f"activities); GraspDatasetGenerator.sample B={GOAL_BATCH}: {gen_ms:.3f} ms "
            f"({self.card})")
        for key, ms in rows[:3]:
            log(f"[profile]   goal update: {ms:.3f} ms  {key[:100]}")

    def goal_level_inputs(self, goal, cloud):
        """[(label, kernel, args)] of one GoalFeature train forward on `cloud`
        (B, 512, 3): K1 and K2 at SA1 (128 centres) and SA2, K5 at both,
        K6 at SA3, computed with the plain versions."""
        sampling, sa_train = self.sampling, self.sa_train
        xyz = feats = cloud.contiguous()
        calls = []
        for (name, npoint, radius, nsample), level in zip(GOAL_LEVELS, goal.encoder.sa):
            calls.append((f"goal {name}", "fps", (xyz, npoint)))
            new_xyz = sampling.gather_points(xyz, sampling.fps_reference(xyz, npoint))
            calls.append((f"goal {name}", "ball_query", (new_xyz, xyz, radius, nsample)))
            idx = sampling.ball_query_reference(new_xyz, xyz, radius, nsample)
            full = torch.cat([xyz, feats], dim=-1)
            cpad = torch.nn.functional.pad(new_xyz, (0, full.shape[-1] - 3))
            dense = train_dense(level)
            calls.append((f"goal {name}", "sa_train", (idx, full, cpad, dense)))
            with torch.no_grad():
                xyz, feats = new_xyz, sa_train.sa_train_reference(idx, full, cpad, dense)[0]
        calls.append(("goal SA3", "groupall_train",
                      (torch.cat([xyz, feats], dim=-1), train_dense(goal.encoder.sa[2]))))
        return calls

    # -- phase 14: image mode ----------------------------------------------------------------
    def image_path(self):
        """One image-mode `Trainer` iteration at full width, as a user runs
        it: TrainConfig() with use_image and domain_rand at IMAGE_ENVS envs
        (AgentConfig.image_size 112, so a 112 x 112 camera; two ResNet-18
        encoders; 4 DDPG updates at batch 256; a 100,000-transition ring
        with bfloat16 frames; EnvParams()'s CHOMP planner) on the YCB
        proxies. A warm-up iteration, then one counted and timed: the image
        agent encodes no points, so K1-K6 launch 0 times and K7 as in phase
        11 (2 per reset, 1 per step, 11 per retract). Returns (the Trainer,
        the timed iteration's record, {kernel: launches over it})."""
        import tempfile

        from gaddpg_tpu_torch.envs.assets import library_from_index
        from gaddpg_tpu_torch.train import Trainer, load_config

        card = self.card
        cfg = load_config(overrides={"use_image": True, "domain_rand": True,
                                     "num_envs": IMAGE_ENVS,
                                     "output_dir": tempfile.mkdtemp(prefix="image_")},
                          policy="DDPG")
        cam = cfg.env.camera
        shape = (cfg.agent.image_size, cam.width, cam.height, cfg.env.domain_rand,
                 cfg.env.use_planner, cfg.batch_size, cfg.updates_per_iter, cfg.buffer_size)
        if shape != (112, 112, 112, True, True, 256, 4, 100000):
            raise AssertionError(f"image: the configuration gives {shape}")
        t0 = time.perf_counter()
        tr = Trainer(cfg, lib=library_from_index("ycb", "train"))  # device="cuda"
        torch.cuda.synchronize()
        frame = tr.buffer.image_state[0].nbytes
        log(f"[image] Trainer(use_image, domain_rand) at {IMAGE_ENVS} envs, {cam.width} x "
            f"{cam.height} RGBDM, two ResNet-18 encoders, batch {cfg.batch_size}, "
            f"{cfg.updates_per_iter} updates per train_iter, ring of {cfg.buffer_size}: replay "
            f"{tr.buffer.nbytes} bytes on the card ({tr.buffer.image_state.dtype} frames of "
            f"{frame} bytes, {tr.buffer.image_state.nbytes} bytes in all); set up in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
        torch.cuda.reset_peak_memory_stats()
        warm = self.timed_iteration(tr)
        log(f"[image] warm-up iteration: collect {warm['collect_ms']:.3f} ms, train_iter "
            f"{warm['train_ms']:.3f} ms ({card})")
        # the main path: one iteration, counted and timed
        self.reset_counts()
        it = self.timed_iteration(tr, counts=True)
        stats, collect_counts, metrics, train_counts = (it[k] for k in (
            "stats", "collect_counts", "metrics", "train_counts"))
        horizon = cfg.rollout_horizon
        want_collect = {k: 0 for k in self.wrappers}
        want_collect["contact_scan"] = RESET_K7 + STEP_K7 * horizon + RETRACT_K7
        want_train = {k: 0 for k in self.wrappers}
        if collect_counts != want_collect or train_counts != want_train:
            raise AssertionError(f"image: launches {collect_counts} in collect, {train_counts} "
                                 f"in train_iter; expected {want_collect}, {want_train}")
        per_iter = {k: collect_counts[k] + train_counts[k] for k in self.wrappers}
        bad = [k for k, v in {**stats, **metrics}.items() if not np.isfinite(v)]
        if bad or not metrics or tr.update_step != 2 * cfg.updates_per_iter:
            raise AssertionError(f"image: non-finite or missing metrics {bad} {metrics}, "
                                 f"update_step {tr.update_step}")
        n = tr.buffer.filled
        frames = tr.buffer.image_state[:n].float()
        if tr.buffer.image_state.dtype != torch.bfloat16 or not torch.isfinite(frames).all() \
                or not bool((frames[:, 4] == 0).any()):
            raise AssertionError("image: the ring's frames are not finite bfloat16 RGBDM with "
                                 "target pixels")
        del frames
        collect_ms, train_ms = it["collect_ms"], it["train_ms"]
        steps = IMAGE_ENVS * horizon
        log(f"[image] launches per image iteration (collect + train_iter): {per_iter}; collect "
            f"{collect_counts}, train_iter {train_counts}: the image agent encodes no points "
            f"(K1-K6 0), K7 per reset, step and retract as in phase 11 ({card})")
        log(f"[image] collect: {collect_split(it['spans'], collect_ms, horizon)} (host clock, "
            f"synchronised around each; the counted iteration after a warm-up; {card})")
        log(f"[image] collect: {steps} env steps ({IMAGE_ENVS} envs x {horizon}), "
            f"{steps / collect_ms * 1e3:.1f} env steps/s; {it['inserted']} valid transitions "
            f"inserted; valid scenes {stats['valid_scene_frac']:.4f}, success "
            f"{stats['rollout_success']:.4f}, explore share {stats['explore_frac']:.4f} ({card})")
        log(f"[image] train_iter: {train_ms:.3f} ms, {train_ms / cfg.updates_per_iter:.3f} ms per "
            f"update; iteration {collect_ms + train_ms:.3f} ms; metrics " + ", ".join(
                f"{k} {v:.5g}" for k, v in metrics.items()) + f" ({card})")
        return tr, it, per_iter

    def image_timings(self, tr):
        """The image agent's calls at full width on the Trainer's state and
        ring: a DDPG and a BC update at batch 256 (host clock, median of 3
        after a warm-up; device busy and idle share under torch.profiler)
        and select_action at B = 1 and IMAGE_ENVS on the ring's frames;
        then the phase's peak memory."""
        from gaddpg_tpu_torch import replay
        from gaddpg_tpu_torch.agents import make_bc_update, make_select_action

        card, cfg = self.card, tr.cfg
        batch = replay.sample(tr.buffer, cfg.batch_size, episode_max_len=8,
                              generator=tr.generator)
        state = tr.agent_state
        bc = make_bc_update(cfg.agent)
        select = make_select_action(cfg.agent)
        idx = torch.randint(0, tr.buffer.filled, (IMAGE_ENVS,), generator=tr.generator,
                            device=self.device)
        images = tr.buffer.image_state[idx].float()
        calls = {"ddpg update": lambda: tr.update(state, batch, tr.generator),
                 "bc update": lambda: bc(state, batch)}
        for b in (1, IMAGE_ENVS):
            calls[f"select_action B={b}"] = (
                lambda b=b: select(state, images[:b], torch.full((b,), 10.0, device=self.device)))
        for name, fn in calls.items():
            out = fn()
            if "update" in name:
                bad = [k for k, v in out.items() if not torch.isfinite(v).all()]
            else:
                bad = [] if torch.isfinite(out[0]).all() else ["action"]
            if bad:
                raise AssertionError(f"image {name}: non-finite {bad}")
            ms = host_ms(fn, reps=3)
            busy, rows, _, n = device_profile(fn, calls=1, count=True, host_ops=False)
            note = ("device time not measured (the profiler saw no device activity)" if not busy
                    else f"device busy {busy:.3f} ms, idle share {max(0.0, 1 - busy / ms):.3f}, "
                         f"{n:.0f} device activities; top: " + "; ".join(
                             f"{k[:60]} {v:.3f} ms" for k, v in rows[:3]))
            log(f"[image] {name} (batch {cfg.batch_size if 'update' in name else ''}): "
                f"{ms:.3f} ms (host clock, median of 3); {note} ({card})")
        log(f"[memory] image phase peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB ({card})")

    def image_rule(self, label, env, env_c, st_g, gen):
        """The card's render of the card's own env state against the CPU's
        render of that same state, with the same draws: at most
        IMAGE_EDGE_SHARE of a view's pixels may differ (mask, depth by more
        than 1e-4 m or RGB by more than 1e-4); returns the largest share."""
        b, p = st_g.obj_idx.shape[0], env_c.p
        draws = {"keep_u": torch.rand((b, p.new_points_per_step), generator=gen),
                 "idx": torch.zeros((b, p.uniform_num_pts), dtype=torch.int64),
                 "image_noise": torch.randn((b, 3, p.camera.height, p.camera.width),
                                            generator=gen)}
        img_g = env._observe_impl(st_g, draws=draws)[1].image.cpu()
        img_c = env_c._observe_impl(st_g.to("cpu"), draws=draws)[1].image
        if not torch.isfinite(img_g).all() or img_g.shape[1:] != (5, p.camera.height,
                                                                   p.camera.width):
            raise AssertionError(f"image {label}: card images {tuple(img_g.shape)} not finite")
        off = ((img_g[:, 4] != img_c[:, 4]) | ((img_g[:, 3] - img_c[:, 3]).abs() > 1e-4)
               | ((img_g[:, :3] - img_c[:, :3]).abs() > 1e-4).any(dim=1))
        share = off.float().mean(dim=(1, 2))
        rgb = (img_g[:, :3] - img_c[:, :3]).abs().amax(dim=1)[~off].max().item()
        if share.max() > IMAGE_EDGE_SHARE:
            raise AssertionError(f"image {label}: pixel shares off {share.tolist()} (bound "
                                 f"{IMAGE_EDGE_SHARE})")
        log(f"[image]   {label}: card vs CPU render of the card's state: pixels off per view "
            f"{[round(x, 5) for x in share.tolist()]} (mask differs on "
            f"{int((img_g[:, 4] != img_c[:, 4]).sum())} of {img_g[:, 4].numel()}), RGB elsewhere "
            f"within {rgb:.2e}")
        return share.max().item()

    @staticmethod
    def goal_near_ties(env_c):
        """`compare_env`'s `goal_ties` for the image check: the CPU's goal
        query on the card's state (phase 12's rule), keeping the card's own
        goal where its point-matching distance from the card's hand lies
        within GOAL_TIE_TOL of the CPU's choice: the two devices compute
        the distances of one state in another order, so a near-tie falls
        either way."""
        from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
        from gaddpg_tpu_torch.geometry.se3 import se3_inverse

        fingers = torch.tensor(HAND_FINGER_POINTS, dtype=torch.float32)

        def ties(g):
            ref = env_c._update_goal(g)
            hand_inv = se3_inverse(env_c._hand(g))
            obj = env_c._obj_pose(g.phys.obj)

            def dist(goal_obj):
                rel = hand_inv @ obj @ goal_obj
                pts = rel[:, :3, :3] @ fingers + rel[:, :3, 3:]
                return (fingers - pts).abs().sum(dim=-2).mean(dim=-1)

            gap = (dist(g.goal_obj) - dist(ref.goal_obj)).abs()
            tie = gap <= GOAL_TIE_TOL
            broken = tie & (g.goal_obj != ref.goal_obj).flatten(1).any(dim=1)
            if broken.any():
                log(f"[image]   envs {broken.nonzero()[:, 0].tolist()}: the devices pick other "
                    f"grasps at distances {[f'{x:.2e}' for x in gap[broken].tolist()]} m apart "
                    f"(a near-tie, bound {GOAL_TIE_TOL})")
            return dataclasses.replace(
                ref, goal_obj=torch.where(tie[:, None, None], g.goal_obj, ref.goal_obj))

        return ties

    def image_card_vs_cpu(self, lib):
        """The image env at B=8 on the card and on the CPU, EnvParams(
        use_image, domain_rand, 112 x 112) with its CHOMP planner, CPU
        generators in the same state on both sides (the visual seeds and
        the pixel noise among their draws): each of two reset tries'
        reset_scene from the CPU's scene, IMAGE_STEPS planner-expert steps
        (each from the CPU's state) and retract_batched within phase 9's
        env rule, the grasp goal held as phase 12 holds it (`compare_env`'s
        `goal_ties`: the arm differs by up to two servo quanta, which moves
        the hand across near-ties of the nearest-grasp query) and, on the
        card's own state, by `goal_near_ties`, the reset plans within phase
        8's plan_rule, and every view by `image_rule`."""
        from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv, _where
        from gaddpg_tpu_torch.expert.chomp import plan_to_goal
        from gaddpg_tpu_torch.physics.types import map_tensors
        from gaddpg_tpu_torch.render.camera import CameraParams

        b = IMAGE_CHECK_BATCH
        p = EnvParams(camera=CameraParams(width=112, height=112), use_image=True, domain_rand=True)
        env, env_c = PandaGraspEnv(p, lib), PandaGraspEnv(p, lib, device="cpu")
        gens = [torch.Generator().manual_seed(51) for _ in range(2)]
        view_gen = torch.Generator().manual_seed(52)
        nudge_gen = torch.Generator().manual_seed(53)
        rep = lambda t, envs: t[envs].repeat(ULP_PROBES, *([1] * (t.dim() - 1)))  # noqa: E731
        card = lambda x: {k: v.to(self.device) for k, v in x.items()}  # noqa: E731

        def nudge(pos):
            return one_ulp(pos, nudge_gen)

        plans = {"chaotic": 0, "branch": 0, "left": 0}
        worst, edge, chaotic = 0.0, 0.0, torch.zeros(b, dtype=torch.bool)
        st_c = ob_c = None
        for r in range(p.reset_tries):
            scene = env_c.sample_scene(b, torch.Generator().manual_seed(60 + r))
            rs_g, ro_g = env.reset_scene(card(scene), gens[0])
            rs_c, ro_c = env_c.reset_scene(scene, gens[1])
            if not torch.equal(rs_g.vis_seed.cpu(), rs_c.vis_seed):
                raise AssertionError("image B=8: the visual seeds differ card vs CPU")
            # the reset's plans against the CPU's planner from the card's own state
            inputs = env_c.plan_inputs(rs_g.to("cpu"))
            ref = env_c.replan(rs_g.to("cpu"))

            def probe(envs, inputs=inputs):  # every planner input nudged, as phase 8's
                sub = {k: (nudge(rep(v, envs)) if torch.is_tensor(v) else v)
                       for k, v in inputs.items()}
                pl, oks = plan_to_goal(**sub)
                return pl.view(ULP_PROBES, len(envs), *pl.shape[1:]), oks.view(ULP_PROBES, -1)

            got = plan_rule(f"image B=8 reset try {r}", rs_g.plan.cpu(), rs_g.plan_ok.cpu(),
                            ref.plan, ref.plan_ok, probe)
            for k in plans:
                plans[k] += got[f"n_{k}"]

            def reset_probe(envs, scene=scene):
                sub = {k: rep(v, envs) for k, v in scene.items()}
                sub["obj_pos"] = nudge(sub["obj_pos"])
                return env_c.reset_scene(sub)[0]

            w, ch = self.compare_env(f"image reset try {r}", rs_g, ro_g, rs_c, ro_c, 1e-6,
                                     reset_probe, goal_ties=self.goal_near_ties(env_c))
            worst, chaotic = max(worst, w), chaotic | ch
            edge = max(edge, self.image_rule(f"reset try {r}", env, env_c, rs_g, view_gen))
            if st_c is None:
                st_c, ob_c = rs_c, ro_c
            else:  # the first valid try per env, as `reset` keeps it
                keep = st_c.valid_scene
                st_c, ob_c = _where(keep, st_c, rs_c), _where(keep, ob_c, ro_c)
        for i in range(IMAGE_STEPS):
            prev, acts = st_c, env_c.expert_action(st_c)
            got = env.step_batched(prev.to(self.device), acts.to(self.device), gens[0])
            st_c, ob_c, _, _, _ = env_c.step_batched(prev, acts, gens[1])

            def step_probe(envs, prev=prev, acts=acts):
                sub = nudge_state(map_tensors(prev, lambda t: rep(t, envs)), nudge)
                return env_c.step_batched(sub, rep(acts, envs))[0]

            w, ch = self.compare_env(f"image step {i}", got[0], got[1], st_c, ob_c,
                                     2 * ARM_SERVO_QUANTUM, step_probe,
                                     goal_ties=self.goal_near_ties(env_c))
            worst, chaotic = max(worst, w), chaotic | ch
            edge = max(edge, self.image_rule(f"step {i}", env, env_c, got[0], view_gen))
        lift_g = env.retract_batched(st_c.to(self.device))[1].cpu()
        lift_c = env_c.retract_batched(st_c)[1]
        differ = (lift_g != lift_c).nonzero()[:, 0]
        if len(differ):
            probe = env_c.retract_batched(nudge_state(map_tensors(st_c, lambda t: rep(t, differ)),
                                                      nudge))[1]
            if not (probe.view(ULP_PROBES, -1) != lift_c[differ]).any(dim=0).all():
                raise AssertionError(f"image B=8: lifts {lift_g.tolist()} vs "
                                     f"{lift_c.tolist()}, not from a chaotic grasp")
        log(f"[image] B=8 card vs CPU: {p.reset_tries} reset tries, {IMAGE_STEPS} planner-expert "
            f"steps and retract_batched within phase 9's rule (chaotic envs "
            f"{chaotic.nonzero()[:, 0].tolist()}, largest unmatched point share {worst:.4f}); "
            f"the reset plans within plan_rule ({plans['chaotic']} chaotic, {plans['branch']} "
            f"on another IK branch, {plans['left']} left); largest share of a view's pixels off "
            f"{edge:.5f} (bound {IMAGE_EDGE_SHARE}); valid {st_c.valid_scene.tolist()}; lifts "
            f"card {lift_g.tolist()}, CPU {lift_c.tolist()} ok ({self.card})")
        return ob_c.image

    def image_agent_checks(self, tr, frames):
        """ImageFeature card vs CPU at B=8 on the same weights (the
        Trainer's encoders) and real frames, eval and train forward, within
        IMAGE_FEATURE_TOL of the output's largest magnitude; one image DDPG
        and one image BC update at B=8 from a common state (carried Adam
        moments, the Q2 hard copy on) within phase 6's rule, on a batch of
        the ring's transitions; the export_torch_state -> .npz ->
        pretrained_resnet round trip giving both encoders the source
        encoder's features; and utils.video.record_episode for one episode
        at B=1 (the per-env step, the image policy)."""
        import tempfile

        from gaddpg_tpu_torch import replay
        from gaddpg_tpu_torch.agents import (
            AgentConfig, create_agent_state, make_bc_update, make_ddpg_update, make_select_action,
        )
        from gaddpg_tpu_torch.models import resnet
        from gaddpg_tpu_torch.utils import video

        card, b = self.card, IMAGE_CHECK_BATCH
        feat = tr.agent_state.feat
        feat_c = copy.deepcopy(feat).to("cpu")
        img = frames[:b].to(self.device)
        act = torch.rand((b, 6), generator=torch.Generator().manual_seed(54)) * 0.1 - 0.05
        errs = {}
        with torch.no_grad():
            for mode, train in (("eval", False), ("train", True)):
                for path, kw in (("policy", {}), ("value", {"action": act, "value": True})):
                    got = feat(img, **{k: (v.to(self.device) if torch.is_tensor(v) else v)
                                       for k, v in kw.items()}, train=train)
                    want = feat_c(img.cpu(), **kw, train=train)
                    got, want = (got[0], want[0]) if train else (got, want)
                    err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
                    errs[f"{path} {mode}"] = err
                    if err > IMAGE_FEATURE_TOL[mode]:
                        raise AssertionError(f"image: ImageFeature {path} {mode} card vs CPU off "
                                             f"by {err:.3e} of the output's largest")
        log(f"[image] ImageFeature card vs CPU at B={b}, 112 x 112, the Trainer's weights: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" of the output's largest (bounds {IMAGE_FEATURE_TOL}) ok ({card})")

        cfg = AgentConfig(use_image=True, target_update_interval=1)
        batches = [replay.sample(tr.buffer, b, episode_max_len=8, generator=tr.generator)
                   for _ in range(3)]
        for name, make in (("ddpg", make_ddpg_update), ("bc", make_bc_update)):
            update, update_c = make(cfg), make(cfg, device="cpu")
            state_c = create_agent_state(cfg, generator=torch.Generator().manual_seed(55),
                                         device="cpu")
            draws = [torch.rand((b, 6), generator=torch.Generator().manual_seed(56 + i))
                     for i in range(2)]
            args = (lambda i: {"noise_draws": draws[i]}) if name == "ddpg" else (lambda i: {})
            update_c(state_c, _cpu(batches[0]), **args(0))  # carried Adam moments
            state_c.update_step = 0
            before, state = state_c.to("cpu"), state_c.to(self.device)
            got = update(state, batches[1], **{k: v.to(self.device) for k, v in args(1).items()})
            want = update_c(state_c, _cpu(batches[1]), **args(1))
            merr = 0.0
            for k, w in want.items():
                torch.testing.assert_close(got[k].cpu(), w, rtol=1e-3, atol=1e-3, msg=k)
                merr = max(merr, (got[k].cpu() - w).abs().item())
            serr, _ = self.compare_updated(cfg, before, state, state_c)
            log(f"[image] {name} update B={b} card vs CPU from a common state: metrics within "
                f"{merr:.3e}, running statistics {serr:.3e}, parameter and target moves within "
                f"phase 6's bounds ok ({card})")

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "encoder.npz")
            np.savez(path, **resnet.export_torch_state(feat.encoder))
            loaded = create_agent_state(AgentConfig(use_image=True, pretrained_resnet=path))
        with torch.no_grad():
            want = feat.encoder(img)
            gaps = [(enc(img) - want).abs().max().item()
                    for enc in (loaded.feat.encoder, loaded.feat.value_encoder)]
        if max(gaps) > 0.0:
            raise AssertionError(f"image: the exported encoder's features differ by {gaps}")
        log(f"[image] export_torch_state -> .npz -> pretrained_resnet: both encoders give the "
            f"source encoder's features bit for bit on the card ok")

        t0 = time.perf_counter()
        frames_ep, reward, infos = video.record_episode(
            tr.env, tr.agent_state, make_select_action(tr.cfg.agent),
            torch.Generator(device=self.device).manual_seed(57), max_steps=VIDEO_STEPS,
            use_image_policy=True)
        if frames_ep.shape[1:] != (5, 112, 112) or not np.isfinite(frames_ep).all():
            raise AssertionError(f"image: record_episode frames {frames_ep.shape}")
        log(f"[image] utils.video.record_episode at B=1 (the image policy, the per-env step, "
            f"max_steps={VIDEO_STEPS}): "
            f"{len(frames_ep)} frames of {frames_ep.shape[1:]}, finite, lift {reward}, in "
            f"{time.perf_counter() - t0:.1f} s ok ({card})")

    def kernel_line(self, totals):
        rows = []
        for kernel in self.wrappers:
            t = totals[kernel]
            bms, by = bound_ms(t["bytes"], t["flops"], kernel_peak(kernel))
            rows.append({
                "name": kernel,
                "route": "cuda",
                "source": f"gaddpg_tpu_torch/ops/csrc/{SOURCES.get(kernel, kernel)}.cu",
                "replaces": REPLACES[kernel],
                "launches": self.launches[kernel],
                "launches_per_train_iter": self.per_iter[kernel],
                "launches_per_clutter_iter": self.per_clutter_iter[kernel],
                "launches_per_goal_update": self.per_goal_update[kernel],
                "launches_per_image_iter": self.per_image_iter[kernel],
                "launches_per_dp_iter": self.per_dp_iter[kernel],
                "launches_per_image_dp_iter": self.per_image_dp_iter[kernel],
                "max_abs_err": self.errors[kernel],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": bms,
                "bound_by": by,
                "library_ms": None,
                "dp_split_ms": self.dp_split_ms.get(kernel),
            })
        return {"kernels": rows}


def collect_split(spans, collect_ms, horizon):
    """A collect's host-clock split from `Smoke.timed_iteration`'s spans."""
    rest = collect_ms - sum(v for k, v in spans.items() if k != "plan")
    return (f"{collect_ms:.3f} ms: reset {spans['reset']:.3f} (of which the CHOMP planner "
            f"{spans.get('plan', 0.0):.3f}), {horizon} steps {spans['steps']:.3f} "
            f"({spans['steps'] / horizon:.3f} per step), DAgger replans "
            f"{spans.get('dagger', 0.0):.3f}, retract {spans['retract']:.3f}, insert "
            f"{spans['insert']:.3f}, policy, expert and selects {rest:.3f}")


def crossing_groups(offs):
    """The groups of `offs` ({group: (off, total, share bound)}) past
    their bound."""
    return [g for g, (off, total, share) in offs.items() if off > share * total]


def crossing_verdict(offs, spreads):
    """Why the card's update `offs` fails the nudge rule, or "" if it
    holds: every group past its bound must be crossed by at least one of
    the CPU's one-ulp nudged updates `spreads` ([{group: off}], each
    against the CPU update), and the card's count must lie within
    CROSSING_MATCH of the count of some nudge that crosses. Such a
    crossing is a rounding tie of the reference arithmetic, which falls
    either way by itself; an event of another size, or on a batch no nudge
    tips over, is the card's."""
    why = []
    for g in crossing_groups(offs):
        off, total, share = offs[g]
        over = [sp[g] for sp in spreads if sp[g] > share * total]
        if not over:
            why.append(f"{g} {off} of {total} off and no one-ulp nudge of "
                       f"{len(spreads)} crosses its bound")
        elif not any(abs(off - c) <= CROSSING_MATCH * c for c in over):
            why.append(f"{g} {off} of {total} off, not within {CROSSING_MATCH:.0%} of the "
                       f"nudges that cross ({sorted(over)})")
    return "; ".join(why)


def planner_env(lib=None):
    """`PandaGraspEnv(EnvParams())` on the card: bench.py's env half
    (bench.py:53), the CHOMP planner expert, on the YCB proxy library
    unless `lib` is given."""
    from gaddpg_tpu_torch.envs.assets import library_from_index
    from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv

    return PandaGraspEnv(EnvParams(), lib or library_from_index("ycb", "train"))


def seed_range(text):
    """"A-B" (inclusive), "A", or a comma-separated list of those -> a
    tuple of seeds."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return tuple(seeds)


# --plain-on-card: the train kernels that can run their plain version on
# the card in phase 10's update check, and the function each replaces
PLAIN_ON_CARD = {"K5": ("_sa_train_kernels", "sa_train_reference"),
                 "K6": ("_groupall_train_kernels", "groupall_train_reference")}


def clutter_phase(smoke, gen, mark=None, profile=True):
    """Phase 12: the td3_clutter iteration at full width (its parts'
    profile with `profile`: --clutter alone; the full run leaves it out to
    stay within its time limit), then the clutter path at B=8 card vs CPU
    and physics/multi.py against K7."""
    from gaddpg_tpu_torch.envs.assets import library_from_index

    smoke.per_clutter_iter = smoke.clutter_path(profile)
    if mark:
        mark("clutter")
    with torch.no_grad():
        smoke.clutter_card_vs_cpu(library_from_index("ycb", "train"))
        smoke.multi_vs_fast(gen)
    if mark:
        mark("clutter card vs CPU")


def image_phase(smoke, mark=None):
    """Phase 14: the image-mode iteration at full width, the image agent's
    timings, the B=8 image env, encoder and updates card vs CPU, the
    export round trip and record_episode."""
    from gaddpg_tpu_torch.envs.assets import library_from_index

    t0 = time.perf_counter()
    tr, _, smoke.per_image_iter = smoke.image_path()
    smoke.image_timings(tr)
    if mark:
        mark("image loop")
    frames = smoke.image_card_vs_cpu(library_from_index("ycb", "train"))
    smoke.image_agent_checks(tr, frames)
    del tr
    torch.cuda.empty_cache()
    if mark:
        mark("image card vs CPU")
    log(f"[image] phase 14 took {time.perf_counter() - t0:.1f} s ({smoke.card})")


# run in a CLI child before the CLI's own main: the kernels' launch counts,
# printed as one line when the child exits
_COUNTING_CHILD = """
import atexit, json, runpy, sys
from gaddpg_tpu_torch.ops import contact_scan, sa, sa_train, sampling
wrappers = {"fps": sampling.furthest_point_sampling, "ball_query": sampling.ball_query,
            "sa_gather_mlp": sa.sa_gather_mlp, "mlp_maxpool": sa.mlp_maxpool,
            "sa_train": sa_train.sa_train_fused, "groupall_train": sa_train.groupall_train_fused,
            "contact_scan": contact_scan.contact_scan}
atexit.register(lambda: print("[launches] " + json.dumps(
    {k: w.launches for k, w in wrappers.items()}), flush=True))
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def cli_phase(smoke, mark=None):
    """Phase 15: the CLIs as child processes, as a user runs them:
    train_online.sh's command for one iteration of td3_critic_aux_policy_aux.yaml
    at its own sizes (counted: the child prints the kernels' launches when
    it exits), test_ycb.sh's evaluator on its checkpoint for one wave of
    CLI_EPISODES episodes with the policy and with --expert (the two at
    once), then show_metrics. Each must exit 0."""
    import tempfile

    from gaddpg_tpu_torch.cli.show_metrics import summarize

    card = smoke.card
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    tmp = tempfile.mkdtemp(prefix="cli_")
    run_dir = os.path.join(tmp, "run")

    def start(argv):
        return subprocess.Popen([sys.executable, *argv], cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def finish(label, proc, t0):
        try:
            out, _ = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"cli: {label} did not end within {CLI_TIMEOUT} s")
        secs = time.perf_counter() - t0
        for line in out.strip().splitlines()[-12:]:
            log(f"[cli]   {label}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"cli: {label} exited {proc.returncode}")
        return out, secs

    t0 = time.perf_counter()
    argv = ["-m", "gaddpg_tpu_torch.cli.train_online", "--config_file", CLI_CFG,
            "--policy", "DDPG", "--max_iters", "1", "--log_dir", run_dir]
    out, secs = finish("train_online", start(["-c", _COUNTING_CHILD] + argv[1:]), t0)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    shape = (cfg["num_envs"], cfg["batch_size"], cfg["updates_per_iter"], cfg["buffer_size"],
             cfg["dagger"], cfg["onpolicy"], cfg["env"]["use_planner"])
    if shape != (256, 128, 20, 500000, True, True, True):
        raise AssertionError(f"cli: train_online ran {shape}")
    counts = json.loads(out.split("[launches] ")[-1].splitlines()[0])
    if min(counts.values()) == 0:
        raise AssertionError(f"cli: train_online left a kernel unlaunched: {counts}")
    m = summarize(run_dir)
    if not os.path.exists(os.path.join(run_dir, "agent_latest.pt")) or m is None or \
            m["step"] != cfg["updates_per_iter"] or not all(np.isfinite(list(m.values()))):
        raise AssertionError(f"cli: train_online left {os.listdir(run_dir)}, metrics {m}")
    log(f"[cli] train_online (td3_critic_aux_policy_aux.yaml, 1 iteration at {cfg['num_envs']} "
        f"envs, {cfg['updates_per_iter']} updates at batch {cfg['batch_size']}, a ring of "
        f"{cfg['buffer_size']}): exit 0 in {secs:.1f} s wall (the child's start, imports and "
        f"set-up included); the iteration: collect {m['rollout_time'] * 1e3:.3f} ms, train_iter "
        f"{m['train_time'] * 1e3:.3f} ms; launches in the child {counts} ({card})")
    if mark:
        mark("cli train_online")

    t0 = time.perf_counter()
    evals = {}
    for label, extra in (("policy", []), ("expert", ["--expert"])):
        evals[label] = start(["-m", "gaddpg_tpu_torch.cli.train_test_offline", "--test",
                              "--config_file", CLI_CFG, "--pretrained", run_dir, "--index_file",
                              "ycb", "--num_runs", "1", "--episodes", str(CLI_EPISODES),
                              "--log_dir", os.path.join(tmp, f"eval_{label}")] + extra)
    rates = {}
    for label, proc in evals.items():
        out, secs = finish(f"train_test_offline {label}", proc, t0)
        if f"loaded {run_dir} @ step {cfg['updates_per_iter']}" not in out:
            raise AssertionError(f"cli: the {label} evaluator did not load the checkpoint")
        rates[label] = float(out.split("overall:")[-1].split()[0])
        log(f"[cli] train_test_offline --test ({label}, {CLI_EPISODES} episodes: one wave of "
            f"{cfg['num_envs']} envs on the ycb library): success {rates[label]:.3f}, exit 0 "
            f"in {secs:.1f} s wall, the two evaluators running at once ({card})")
    t0 = time.perf_counter()
    out, secs = finish("show_metrics", start(["-m", "gaddpg_tpu_torch.cli.show_metrics",
                                              run_dir]), t0)
    if "critic_loss" not in out:
        raise AssertionError("cli: show_metrics printed no critic_loss")
    log(f"[cli] show_metrics: exit 0 in {secs:.1f} s; success rates policy {rates['policy']:.3f}, "
        f"expert {rates['expert']:.3f} ({card})")
    if mark:
        mark("cli evaluators")


def _build_library(index, path, where):
    """A child process's work: `index`'s library built on the CPU, saved
    to `path` (the JAX package's .npz layout), its seconds beside it."""
    from gaddpg_tpu_torch.data.mesh_native import native_available
    from gaddpg_tpu_torch.envs.assets import library_from_index, save_library

    torch.set_num_threads(1)  # host work beside the card's phases: leave them the cores
    t0 = time.perf_counter()
    if index == DP_FLAGSHIP:
        from gaddpg_tpu_torch.parallel.dryrun import build_flagship_library

        build_flagship_library(path)
    else:
        save_library(library_from_index(index), path)
    secs = time.perf_counter() - t0
    with open(path + ".json", "w") as f:
        json.dump({"seconds": secs, "native": native_available(), "where": where}, f)


class LibraryBuild:
    """`library_from_index(index)` in a child process on the host's CPU:
    the grasp rig is host work that takes about a minute for 4 objects, so
    a full run starts it before the card's phases and phase 13 collects
    it. The child is a daemon, and `stop` ends it."""

    def __init__(self, index, where):
        import multiprocessing
        import tempfile

        self.path = os.path.join(tempfile.mkdtemp(prefix="proc_lib_"), "lib.npz")
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(target=_build_library, args=(index, self.path, where),
                                daemon=True)
        self.proc.start()

    def result(self):
        from gaddpg_tpu_torch.envs.assets import load_library

        self.proc.join(LIBRARY_BUILD_TIMEOUT)
        if self.proc.is_alive() or self.proc.exitcode != 0:
            self.stop()
            raise AssertionError(f"proc: the library build ended with {self.proc.exitcode}")
        with open(self.path + ".json") as f:
            return load_library(self.path), json.load(f)

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


def proc_phase(smoke, gen, build, mark=None):
    """Phase 13: the procedural library built on the CPU (`build`), one
    TrainConfig() iteration on it, K7 and K1-K4 on its scenes and clouds,
    then cli.train_goal and the GoalFeature checks."""
    t0 = time.perf_counter()
    lib = smoke.proc_library(build)
    smoke.per_proc_iter = smoke.loop_path(lib=lib, tag="proc", profile=False, warm=False)
    tr, first = smoke.loop_run
    smoke.loop_run = None
    with torch.no_grad():
        smoke.proc_kernels(tr, first, gen)
    del tr, first
    if mark:
        mark("proc loop")
    smoke.goal_train(lib)
    smoke.goal_card_vs_cpu(lib)
    if mark:
        mark("goal")
    log(f"[proc] phase 13 took {time.perf_counter() - t0:.1f} s ({smoke.card})")


# -- phase 16: data-parallel training ---------------------------------------------------
# Two ranks share the one card over gloo, their collectives staged through
# the host (NCCL refuses two ranks on one device); one rank alone runs over
# NCCL. Ranks sharing one card measure the overhead of the parallel path,
# not a speedup: one card cannot show one.
DP_RANKS = 2
DP_TIMEOUT = 900              # s, each launch of phase 16's ranks
DP_NCCL_INIT_S = 120          # s, the one-rank NCCL group's set-up
DP_TIER_WORLD = 2             # the dry-run tiers at a 2-rank dry run's sizes
DP_SEED = 16                  # the sharded updates' state and batch
DP_FLAGSHIP = "dryrun flagship"  # LibraryBuild: build_proc_library(2, seed0=11)
DP_RING_FIELDS = ("reward", "returns", "episode_map", "timestep", "expert_flags", "terminal")
DP_IMAGE_SEED = 17            # the image agent's state, frames and batch
DP_IMAGE_ENVS = 1024          # the image iteration's envs over both ranks (512 a rank)


def synthetic_frames(batch, gen, side, device):
    """RGBDM frames (B, 5, side, side) from `gen`: RGB in [0, 1), depth in
    [0.2, 1.5) m, a target mask on about a quarter of the pixels."""
    f = torch.rand((batch, 5, side, side), generator=gen, device=device)
    f[:, 3] = 0.2 + 1.3 * f[:, 3]
    f[:, 4] = (f[:, 4] < 0.25).float()
    return f


def image_feature_pass(feat, img, act, mesh=None):
    """ImageFeature's train forward, both encoders (the value path with
    `act`), statistics over every rank's rows with `mesh`: {path: (output,
    [(mean, var)] * 20, gradients of sum(output^2) in the image rows and
    in the encoder's parameters)}, as numpy arrays. The backward runs
    under `f32_matmuls` too, as the updates run theirs: cuDNN's TF32
    default would round the convolutions' gradients to 10 bits."""
    from gaddpg_tpu_torch.utils.precision import f32_matmuls

    return f32_matmuls(_image_feature_pass)(feat, img, act, mesh)


def _image_feature_pass(feat, img, act, mesh):
    out = {}
    for path, kw in (("policy", {}), ("value", {"value": True, "action": act})):
        x = img.clone().requires_grad_()
        y, stats = feat(x, train=True, mesh=mesh, **kw)
        enc = feat.value_encoder if kw else feat.encoder
        grads = torch.autograd.grad((y * y).sum(), [x, *enc.parameters()])
        out[path] = (y.detach().cpu().numpy(), [(m.cpu().numpy(), v.cpu().numpy())
                                                for m, v in stats],
                     [g.cpu().numpy() for g in grads])
    return out


def _to(tree, device):
    """Every tensor of `tree` (dicts, lists, tuples) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def state_digest(tensors):
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _numpy(tensors):
    """Copies of `tensors` as numpy arrays (never views of a tensor that
    moves on)."""
    return [t.detach().cpu().numpy().copy() for t in tensors]


class _RankCounts:
    """The kernels' launch counters and `Smoke.timed_iteration` in a rank,
    without the rest of `Smoke`."""
    counts, reset_counts, timed_iteration = Smoke.counts, Smoke.reset_counts, \
        Smoke.timed_iteration

    def __init__(self):
        self.wrappers = kernel_wrappers()


@contextlib.contextmanager
def collective_clock(total):
    """Host time inside the mesh's collectives (their staging through the
    host, the transfer, the copy back) added to total[0]; the card is
    synchronised before each, so queued work does not count."""
    from gaddpg_tpu_torch.parallel import mesh as mesh_lib

    out_fn, back_fn, t0 = mesh_lib._out, mesh_lib._back, [0.0]

    def out(mesh, x):
        torch.cuda.synchronize()
        t0[0] = time.perf_counter()
        return out_fn(mesh, x)

    def back(x, like):
        y = back_fn(x, like)
        torch.cuda.synchronize()
        total[0] += (time.perf_counter() - t0[0]) * 1e3
        return y

    mesh_lib._out, mesh_lib._back = out, back
    try:
        yield total
    finally:
        mesh_lib._out, mesh_lib._back = out_fn, back_fn


def clocked_call(fn):
    """One call of fn with `collective_clock` on -> (its ms, host clock
    synchronised around it, the ms inside its collectives)."""
    coll = [0.0]
    with collective_clock(coll):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, coll[0]


def dp_kernels_rank(mesh, calls):
    """K5/K6 split at the reduction, on this rank's half of each call's
    rows: against the plain version with the same reduction on the card
    (phase 2's bounds, gradients included), two calls bit-identical ->
    [(pooled, statistics, max_abs_err, grad max_abs_err, ms)]."""
    import functools

    from gaddpg_tpu_torch.ops import sa_train
    from gaddpg_tpu_torch.parallel.mesh import local_slice

    wrappers = kernel_wrappers()
    plain = {"sa_train": sa_train.sa_train_reference,
             "groupall_train": sa_train.groupall_train_reference}
    out = []
    for label, kernel, args in calls:
        *lead, dense = _to(args, mesh.device)
        args = (*(t[local_slice(mesh, t.shape[0])] for t in lead), dense)
        fn = functools.partial(wrappers[kernel], mesh=mesh)
        ref = functools.partial(plain[kernel], mesh=mesh)
        with torch.no_grad():
            got, stats = fn(*args)
            again, stats2 = fn(*args)
            want, want_stats = ref(*args)
        torch.cuda.synchronize()
        flat = [t for mv in stats for t in mv]
        if not torch.equal(got, again) or not all(
                torch.equal(a, b) for a, b in zip(flat, [t for mv in stats2 for t in mv])):
            raise AssertionError(f"{kernel} {label} split: two calls differ")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        err = (got - want).abs().max().item()
        for t, w in zip(flat, [t for mv in want_stats for t in mv]):
            torch.testing.assert_close(t, w, rtol=1e-4, atol=1e-4)
            err = max(err, (t - w).abs().max().item())
        gerr, _ = check_train_grads(f"{kernel} {label} split",
                                    *(train_grads(f, kernel, args) for f in (fn, ref)),
                                    zero_biases=False)
        with torch.no_grad():
            ms = host_ms(lambda: fn(*args), reps=5)
        out.append((got.cpu().numpy(), _numpy(flat), err, gerr, ms))
    return out


def dp_updates_rank(mesh, cfg, start, batch, draws, timed=3):
    """The sharded DDPG and BC updates (`make_sharded_update`, the global
    batch in) from `start` (a CPU AgentState) on this rank, then `timed`
    more of each on the stepped state (host clock), then one with the
    time inside the collectives clocked (`collective_clock`, whose
    synchronisations would slow the timed ones) -> {kind: (metrics, state
    tensors (rank 0's; None on the others), counts, the tensors' digest,
    ms, clocked update ms, of which in collectives)}."""
    from gaddpg_tpu_torch.agents import make_bc_update, make_ddpg_update
    from gaddpg_tpu_torch.agents.state import state_counts, state_tensors
    from gaddpg_tpu_torch.parallel.mesh import make_sharded_update

    dev = mesh.device
    batch, draws = _to(batch, dev), draws.to(dev)
    out = {}
    for kind, make in (("ddpg", make_ddpg_update), ("bc", make_bc_update)):
        state = start.to(dev)
        run = make_sharded_update(make(cfg, dev, mesh=mesh), mesh)
        step = ((lambda: run(state, batch, noise_draws=draws)) if kind == "ddpg"
                else (lambda: run(state, batch)))
        metrics = {k: float(v) for k, v in step().items()}
        # rank 0's tensors for the comparison, every rank's digest for its bits
        tensors = _numpy(state_tensors(state)) if mesh.is_lead else None
        digest, counts = state_digest(state_tensors(state)), state_counts(state)
        out[kind] = (metrics, tensors, counts, digest, host_ms(step, reps=timed),
                     *clocked_call(step))
    return out


def dp_loop_rank(mesh):
    """Phase 16's TrainConfig() iteration, as phase 11 runs it at
    LOOP_ENVS envs, on this rank's share: one iteration, counted and
    timed (`Smoke.timed_iteration`; the rank's first, cold as phase 11's
    first iteration is)."""
    import tempfile

    from gaddpg_tpu_torch.envs.assets import library_from_index
    from gaddpg_tpu_torch.train import Trainer, load_config

    cfg = load_config(overrides={"num_envs": LOOP_ENVS,
                                 "output_dir": tempfile.mkdtemp(prefix="dp_loop_")},
                      policy="DDPG")
    t0 = time.perf_counter()
    tr = Trainer(cfg, lib=library_from_index("ycb", "train"), mesh=mesh)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    counter = _RankCounts()
    counter.reset_counts()
    it = counter.timed_iteration(tr, counts=True)
    keep = ("stats", "collect_ms", "train_ms", "metrics", "inserted", "spans", "calls",
            "collect_counts", "train_counts")
    return {"setup_ms": setup_ms, "horizon": cfg.rollout_horizon,
            "updates": cfg.updates_per_iter, "update_step": tr.update_step,
            "buffer_bytes": tr.buffer.nbytes, **{k: it[k] for k in keep}}


def dp_fast_tier(mesh, output_dir, device="cuda"):
    """The fast dry-run tier at DP_TIER_WORLD ranks' sizes on this mesh
    (one rank: mesh None) with the dry run's checks -> (collect stats,
    the gathered ring, update metrics, update_step, state tensors)."""
    from gaddpg_tpu_torch.agents.state import state_tensors
    from gaddpg_tpu_torch.parallel.dryrun import tier_config, tier_iteration, tier_library
    from gaddpg_tpu_torch.replay.buffer import gather_buffer
    from gaddpg_tpu_torch.train import Trainer

    tr = Trainer(tier_config(DP_TIER_WORLD, output_dir), lib=tier_library(False), mesh=mesh,
                 device=device)
    roll, metrics = tier_iteration(tr, False)
    ring = {k: v.cpu().numpy() for k, v in gather_buffer(tr.buffer).items()}
    return roll, ring, metrics, tr.update_step, _numpy(state_tensors(tr.agent_state))


def dp_image_feature_rank(mesh, feat, img, act):
    """ImageFeature's train forward on this rank's rows of the batch
    (`image_feature_pass`), twice, bit-identical, and the policy encoder's
    train forward timed (host clock, median of 3) -> (the pass, ms)."""
    from gaddpg_tpu_torch.parallel.mesh import local_slice

    dev = mesh.device
    feat = copy.deepcopy(feat).to(dev)
    rows = local_slice(mesh, img.shape[0])
    img, act = img[rows].to(dev), act[rows].to(dev)
    first = image_feature_pass(feat, img, act, mesh)
    again = image_feature_pass(feat, img, act, mesh)
    for path, (y, stats, _) in first.items():
        y2, stats2, _ = again[path]
        if not np.array_equal(y, y2) or not all(
                np.array_equal(a, b) for mv, mv2 in zip(stats, stats2) for a, b in zip(mv, mv2)):
            raise AssertionError(f"dp image {path}: two split forwards differ")
    with torch.no_grad():
        ms = host_ms(lambda: feat(img, train=True, mesh=mesh), reps=3)
    return first, ms


def dp_image_loop_rank(mesh):
    """Phase 16's image iteration on this rank's share:
    load_config(use_image, domain_rand, DP_IMAGE_ENVS envs) on the mesh,
    one iteration, counted and timed (`Smoke.timed_iteration`; cold), with
    this rank's peak allocated memory."""
    import tempfile

    from gaddpg_tpu_torch.envs.assets import library_from_index
    from gaddpg_tpu_torch.train import Trainer, load_config

    gc.collect()  # the point-cloud Trainer before it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(overrides={"use_image": True, "domain_rand": True,
                                 "num_envs": DP_IMAGE_ENVS,
                                 "output_dir": tempfile.mkdtemp(prefix="dp_image_")},
                      policy="DDPG")
    t0 = time.perf_counter()
    tr = Trainer(cfg, lib=library_from_index("ycb", "train"), mesh=mesh)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    counter = _RankCounts()
    counter.reset_counts()
    it = counter.timed_iteration(tr, counts=True)
    local = tr.buffer.size // mesh.world  # this rank's slots of the ring's frames
    frames = tr.buffer.image_state[:min(max(tr.buffer.filled - mesh.rank * local, 0), local)]
    keep = ("stats", "collect_ms", "train_ms", "metrics", "inserted", "spans", "calls",
            "collect_counts", "train_counts")
    return {"setup_ms": setup_ms, "horizon": cfg.rollout_horizon,
            "updates": cfg.updates_per_iter, "update_step": tr.update_step,
            "frames_ok": bool(frames.dtype == torch.bfloat16
                              and torch.isfinite(frames.float()).all()),
            "ring_frames": tuple(tr.buffer.image_state.shape),
            "buffer_bytes": tr.buffer.nbytes,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            **{k: it[k] for k in keep}}


def dp_rank(mesh, calls, cfg, start, batch, draws, work, flagship_lib, image):
    """One of the ranks sharing the card: every part of phase 16 that runs
    on ranks, in order."""
    from gaddpg_tpu_torch.parallel.dryrun import run_tier

    t0 = time.perf_counter()
    out = {"kernels": dp_kernels_rank(mesh, calls),
           "updates": dp_updates_rank(mesh, cfg, start, batch, draws),
           "image_feature": dp_image_feature_rank(mesh, *image["feature"]),
           "image_updates": dp_updates_rank(mesh, *image["updates"], timed=2),
           "loop": dp_loop_rank(mesh)}
    out["image_loop"] = dp_image_loop_rank(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["fast"] = dp_fast_tier(mesh, os.path.join(work, "fast"))
    t1 = time.perf_counter()
    out["flagship"] = run_tier(mesh, True, os.path.join(work, "flagship"), flagship_lib)
    out["flagship_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def _load_state(template, tensors, counts):
    """A copy of `template` holding a rank's state tensors and counts."""
    from gaddpg_tpu_torch.agents.state import set_state_counts, state_tensors

    state = template.to(template.device)
    with torch.no_grad():
        for t, a in zip(state_tensors(state), tensors, strict=True):
            t.copy_(torch.from_numpy(a))
    set_state_counts(state, counts)
    return state


def dp_image_references(smoke):
    """Phase 16's image references without a mesh, on the card: the image
    agent's state (carried Adam moments from one update on other frames),
    ImageFeature's train forward at TRAIN_BATCH on synthetic 112 x 112
    frames (`image_feature_pass`) and its policy encoder's time, and the
    DDPG and BC updates at TRAIN_BATCH. -> (the ranks' image arguments,
    the whole-batch pass, its ms, {kind: (metrics, state after (CPU), ms)},
    the config, the start state (CPU))."""
    from gaddpg_tpu_torch.agents import (
        AgentConfig, create_agent_state, make_bc_update, make_ddpg_update,
    )

    dev = smoke.device
    cfg = AgentConfig(use_image=True, target_update_interval=1, collision_aux_weight=0.1,
                      collision_demo_discount=0.5)
    start = create_agent_state(cfg, generator=torch.Generator().manual_seed(DP_IMAGE_SEED))
    igen = torch.Generator(device=dev).manual_seed(DP_IMAGE_SEED)
    side = cfg.image_size

    def image_batch():
        b = smoke.mixed_batch(TRAIN_BATCH, igen)
        del b["point_state"], b["next_point_state"]
        b["image_state"] = synthetic_frames(TRAIN_BATCH, igen, side, dev)
        b["next_image_state"] = synthetic_frames(TRAIN_BATCH, igen, side, dev)
        return b

    make_ddpg_update(cfg)(start, image_batch())  # carried Adam moments
    start.update_step = 0
    batch = image_batch()
    draws = torch.rand((TRAIN_BATCH, 6), generator=igen, device=dev)
    alone = {}
    for kind, make in (("ddpg", make_ddpg_update), ("bc", make_bc_update)):
        state, upd = start.to(dev), make(cfg)
        step = ((lambda: upd(state, batch, noise_draws=draws)) if kind == "ddpg"
                else (lambda: upd(state, batch)))
        metrics = {k: float(v) for k, v in step().items()}
        alone[kind] = (metrics, state.to("cpu"), host_ms(step, reps=2))
        del state
    img = synthetic_frames(TRAIN_BATCH, igen, side, dev)
    act = torch.rand((TRAIN_BATCH, 6), generator=igen, device=dev) * 0.1 - 0.05
    whole = image_feature_pass(start.feat, img, act)
    with torch.no_grad():
        whole_ms = host_ms(lambda: start.feat(img, train=True), reps=3)
    start_cpu = start.to("cpu")
    feat_cpu = copy.deepcopy(start_cpu.feat)
    image = {"feature": (feat_cpu, img.cpu(), act.cpu()),
             "updates": (cfg, start_cpu, _to(batch, "cpu"), draws.cpu())}
    del start, batch, img, act
    torch.cuda.empty_cache()
    return image, whole, whole_ms, alone, cfg, start_cpu


def dp_image_checks(smoke, ranks, whole, whole_ms, alone, cfg, start_cpu):
    """Phase 16's image parts on the ranks against the references: the
    ImageFeature split by IMAGE_FEATURE_TOL["train"] (outputs and each
    BatchNorm's statistics, of the whole batch's largest) and phase 2's
    gradient rule (each element within 1e-3 of itself plus its leaf's
    largest: the image rows each rank's own, the parameter gradients
    summed over the ranks);
    the sharded image updates by phase 6's rule, every rank's state
    bit-identical; the image iteration counted (K7 as phase 14 counts it,
    K1-K6 0), buffer_idx > 0, update_step 4, finite metrics."""
    card = smoke.card
    errs = {}
    for path, (y, stats, grads) in whole.items():
        parts = [rank["image_feature"][0][path] for rank in ranks]
        got = np.concatenate([p[0] for p in parts])
        err = float(np.abs(got - y).max() / np.abs(y).max())
        serr = 0.0
        for p in parts:
            for (m, v), (wm, wv) in zip(p[1], stats, strict=True):
                for a, w in ((m, wm), (v, wv)):
                    serr = max(serr, float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-30)))
        # phase 2's rule (`check_train_grads`): |g - w| <= 1e-3 (|w| + max |w|)
        # elementwise; gerr is the largest share of that bound used
        gerr, worst = 0.0, 0
        for i, w in enumerate(grads):
            g = (np.concatenate([p[2][i] for p in parts]) if i == 0
                 else np.sum([p[2][i] for p in parts], axis=0))
            used = float((np.abs(g - w) / (1e-3 * (np.abs(w) + np.abs(w).max()) + 1e-30)).max())
            if used > gerr:
                gerr, worst = used, i
        errs[path] = (err, serr, gerr, worst)
        if max(err, serr) > IMAGE_FEATURE_TOL["train"] or gerr > 1.0:
            raise AssertionError(f"dp image {path}: split against the whole batch off by "
                                 f"{err:.3e} (outputs), {serr:.3e} (statistics) of the largest; "
                                 f"gradients at {gerr:.3f} of phase 2's bound (leaf {worst})")
    split_ms = ranks[0]["image_feature"][1]
    smoke.dp_image_split_ms = (split_ms, whole_ms)
    log(f"[dp] ImageFeature train forward at B={TRAIN_BATCH}, 112 x 112, split over {DP_RANKS} "
        f"ranks (20 BatchNorms an encoder, each reduced across the ranks): against the whole "
        f"batch " + ", ".join(f"{p} outputs {e:.2e} and statistics {s_:.2e} of the largest "
                              f"(bound {IMAGE_FEATURE_TOL['train']}), gradients at {g:.3f} of "
                              f"phase 2's bound (leaf {w_})"
                              for p, (e, s_, g, w_) in errs.items())
        + "; two split forwards "
        f"bit-identical; the policy encoder's train forward {split_ms:.3f} ms a rank split "
        f"(rank 0, host clock, each reduction staged through the host) against "
        f"{whole_ms:.3f} ms on the whole batch ok ({card})")
    for kind in ("ddpg", "bc"):
        want, state_ref, ms_alone = alone[kind]
        outs = [r["image_updates"] for r in ranks]
        metrics, tensors, counts, digest, ms, clocked_ms, coll_ms = outs[0][kind]
        if any(o[kind][2] != counts or o[kind][3] != digest for o in outs[1:]):
            raise AssertionError(f"dp image {kind}: the ranks' states differ")
        for k, w in want.items():
            torch.testing.assert_close(torch.tensor(metrics[k]), torch.tensor(w),
                                       rtol=1e-3, atol=1e-3, msg=f"dp image {kind} {k}")
        got = _load_state(start_cpu, tensors, counts)
        serr, offs = smoke.compare_updated(cfg, start_cpu, got, state_ref, quiet=True)
        log(f"[dp] image {kind} update B={TRAIN_BATCH}, 112 x 112, on {DP_RANKS} ranks of one "
            f"card: metrics within 1e-3 of the update without a mesh, running statistics "
            f"max_abs_err={serr:.3e}, moves off " + ", ".join(
                f"{g} {o}/{n}" for g, (o, n, _) in offs.items())
            + f"; every rank's state bit-identical; {ms:.3f} ms an update against "
            f"{ms_alone:.3f} ms without a mesh (host clock, median of 2); with the "
            f"collectives clocked {clocked_ms:.3f} ms, {coll_ms:.3f} of them in the "
            f"collectives ({coll_ms / clocked_ms:.1%}) ok ({card})")

    loops = [r["image_loop"] for r in ranks]
    horizon, updates = loops[0]["horizon"], loops[0]["updates"]
    want_collect = {k: 0 for k in smoke.wrappers}
    want_collect["contact_scan"] = RESET_K7 + STEP_K7 * horizon + RETRACT_K7
    want_train = {k: 0 for k in smoke.wrappers}
    for r, lp in enumerate(loops):
        if lp["collect_counts"] != want_collect or lp["train_counts"] != want_train:
            raise AssertionError(f"dp image loop rank {r}: launches {lp['collect_counts']} in "
                                 f"collect, {lp['train_counts']} in train_iter; expected "
                                 f"{want_collect}, {want_train}")
        st = lp["stats"]
        bad = [k for k, v in {**st, **lp["metrics"]}.items() if not np.isfinite(v)]
        if (st["buffer_idx"] <= 0 or lp["update_step"] != updates or bad or not lp["metrics"]
                or not lp["frames_ok"]):
            raise AssertionError(f"dp image loop rank {r}: buffer_idx {st['buffer_idx']}, "
                                 f"update_step {lp['update_step']}, non-finite {bad}, frames "
                                 f"{lp['frames_ok']}")
    smoke.per_image_dp_iter = {k: loops[0]["collect_counts"][k] + loops[0]["train_counts"][k]
                               for k in smoke.wrappers}
    steps = DP_IMAGE_ENVS * horizon
    collect_ms = max(lp["collect_ms"] for lp in loops)
    it_ms = max(lp["collect_ms"] + lp["train_ms"] for lp in loops)
    log(f"[dp] image iteration (use_image, domain_rand) at {DP_IMAGE_ENVS} envs on {DP_RANKS} "
        f"ranks of one card ({DP_IMAGE_ENVS // DP_RANKS} envs a rank, batch {TRAIN_BATCH}, "
        f"{updates} updates, the ring's frames sharded, {loops[0]['ring_frames']} a rank, "
        f"{loops[0]['buffer_bytes']} bytes of ring a rank): set up "
        f"{max(lp['setup_ms'] for lp in loops):.1f} ms; each rank's launches per iteration "
        f"{smoke.per_image_dp_iter} (K7 as phase 14's, K1-K6 0) ({card})")
    for r, lp in enumerate(loops):
        log(f"[dp] image rank {r}, its first (cold) iteration: collect "
            f"{collect_split(lp['spans'], lp['collect_ms'], horizon)}; train_iter "
            f"{lp['train_ms']:.3f} ms; peak allocated {lp['peak_gib']:.3f} GiB "
            f"(torch.cuda.max_memory_allocated of the rank) ({card})")
    st = loops[0]["stats"]
    log(f"[dp] image iteration {it_ms:.3f} ms (the slower rank; cold), {steps} env steps, "
        f"{steps / collect_ms * 1e3:.1f} env steps/s over both ranks; buffer_idx "
        f"{st['buffer_idx']}, update_step {loops[0]['update_step']}, valid scenes "
        f"{st['valid_scene_frac']:.4f}, metrics " + ", ".join(
            f"{k} {v:.5g}" for k, v in loops[0]["metrics"].items()) + f" ok ({card})")


def dp_phase(smoke, gen, flagship_build, mark=None):
    """Phase 16: data-parallel training with ranks sharing the card, and
    one rank over NCCL (this process, alone in its group). The references
    run here first: the K5/K6 calls on the whole batch, the updates
    without a mesh, the fast tier on one rank."""
    import tempfile

    from gaddpg_tpu_torch.agents import (
        AgentConfig, create_agent_state, make_bc_update, make_ddpg_update,
    )
    from gaddpg_tpu_torch.parallel import init_mesh, launch
    from gaddpg_tpu_torch.parallel.mesh import shutdown

    t_phase = time.perf_counter()
    card, dev = smoke.card, smoke.device
    # K5/K6 at the learner's shapes, scale 1 and 2, on the whole batch
    calls = [(tag + label, kernel, args) for tag, state in (("", None),
                                                           ("scale 2 ", smoke.scale2()[2]))
             for label, kernel, args in smoke.train_calls(TRAIN_BATCH, gen, state)]
    with torch.no_grad():
        whole = [smoke.wrappers[kernel](*args) for _, kernel, args in calls]
    # the updates' common start: a state with carried Adam moments, the actor term on
    cfg = AgentConfig(target_update_interval=1, collision_aux_weight=0.1,
                      collision_demo_discount=0.5)
    start = create_agent_state(cfg, TRAIN_POINTS,
                               generator=torch.Generator().manual_seed(DP_SEED))
    dgen = torch.Generator(device=dev).manual_seed(DP_SEED)
    make_ddpg_update(cfg)(start, smoke.mixed_batch(TRAIN_BATCH, dgen))
    start.update_step = 0
    batch = smoke.mixed_batch(TRAIN_BATCH, dgen)
    draws = torch.rand((TRAIN_BATCH, 6), generator=dgen, device=dev)
    alone = {}
    for kind, make in (("ddpg", make_ddpg_update), ("bc", make_bc_update)):
        state, upd = start.to(dev), make(cfg)
        step = ((lambda: upd(state, batch, noise_draws=draws)) if kind == "ddpg"
                else (lambda: upd(state, batch)))
        metrics = {k: float(v) for k, v in step().items()}
        after = state.to("cpu")
        alone[kind] = (metrics, after, host_ms(step, reps=3))
    if float(alone["ddpg"][0]["actor_critic_loss"]) == 0.0:
        raise AssertionError("dp: the actor term is not live")
    work = tempfile.mkdtemp(prefix="dp_")
    one = dp_fast_tier(None, os.path.join(work, "fast_one"))
    _, info = flagship_build.result()
    log(f"[dp] references on one rank done; the flagship tier's library built in "
        f"{info['seconds']:.1f} s on the host's CPU ({info['where']})")
    start_cpu = start.to("cpu")
    image, whole_image, whole_image_ms, alone_image, image_cfg, image_start = \
        dp_image_references(smoke)
    log("[dp] image references on one rank done")
    # one rank over NCCL, this process alone in its group
    mesh = init_mesh(1, 0, dev, "file://" + os.path.join(work, "nccl-rendezvous"),
                     timeout_s=DP_NCCL_INIT_S)
    try:
        nccl = [dp_updates_rank(mesh, cfg, start_cpu, _to(batch, "cpu"), draws.cpu())]
    finally:
        shutdown()
    args = ([(label, kernel, _to(args, "cpu")) for label, kernel, args in calls],
            cfg, start_cpu, _to(batch, "cpu"), draws.cpu(), work, flagship_build.path, image)
    t0 = time.perf_counter()
    ranks = launch(dp_rank, DP_RANKS, args=args, devices=["cuda:0"] * DP_RANKS,
                   rendezvous_dir=work, timeout_s=DP_TIMEOUT, threads=4)
    log(f"[dp] {DP_RANKS} ranks on one card (gloo, collectives staged through the host): "
        f"launched, ran and joined in {time.perf_counter() - t0:.1f} s, each rank's work "
        + ", ".join(f"{rank['seconds']:.1f}" for rank in ranks) + f" s ({card})")
    if mark:
        mark("dp ranks")

    # K5/K6 split across the ranks against the whole batch
    for i, ((label, kernel, _), (pooled, stats)) in enumerate(zip(calls, whole)):
        flat = [t for mv in stats for t in mv]
        rows = pooled.shape[0] // DP_RANKS
        err = 0.0
        for r, rank in enumerate(ranks):
            got, got_stats, split_err, gerr, ms = rank["kernels"][i]
            want = pooled[r * rows:(r + 1) * rows].cpu()
            torch.testing.assert_close(torch.from_numpy(got), want, rtol=1e-4, atol=1e-4)
            err = max(err, (torch.from_numpy(got) - want).abs().max().item())
            for t, w in zip(got_stats, flat):
                torch.testing.assert_close(torch.from_numpy(t), w.cpu(), rtol=1e-4, atol=1e-4)
                err = max(err, (torch.from_numpy(t) - w.cpu()).abs().max().item())
        smoke.errors[kernel] = max(smoke.errors[kernel], err)
        r0 = ranks[0]["kernels"][i]
        log(f"[dp] {kernel:14s} {label:16s} B={TRAIN_BATCH} split over {DP_RANKS} ranks "
            f"({rows} rows each): against the whole-batch kernel call max_abs_err={err:.3e}, "
            f"against the plain version with the same reduction {r0[2]:.3e}, grad "
            f"max_abs_err={r0[3]:.3e}, two calls bit-identical; {r0[4]:.3f} ms a call on "
            f"rank 0 (host clock, the host-staged reduction included) ok ({card})")

    # K5 and K6 split, summed over one policy-encoder train forward (SA1, SA2; SA3)
    split = {k: sum(rank_k[4] for (label, kernel, _), rank_k in zip(calls, ranks[0]["kernels"])
                    if kernel == k and label.startswith("policy"))
             for k in ("sa_train", "groupall_train")}
    smoke.dp_split_ms = split
    log(f"[dp] one policy-encoder train forward at B={TRAIN_BATCH} split over {DP_RANKS} ranks "
        f"of one card: K5 {split['sa_train']:.3f} ms, K6 {split['groupall_train']:.3f} ms a "
        f"rank (rank 0, host clock, each layer's reduction staged through the host) ({card})")
    # the sharded updates against the update without a mesh, one rank over NCCL too
    for kind in ("ddpg", "bc"):
        want, state_ref, ms_alone = alone[kind]  # state_ref on the CPU
        for where, outs in ((f"{DP_RANKS} ranks, one card, gloo", [r["updates"] for r in ranks]),
                            ("1 rank, NCCL", nccl)):
            metrics, tensors, counts, digest, ms, clocked_ms, coll_ms = outs[0][kind]
            if any(o[kind][2] != counts or o[kind][3] != digest for o in outs[1:]):
                raise AssertionError(f"dp {kind} {where}: the ranks' states differ")
            for k, w in want.items():
                torch.testing.assert_close(torch.tensor(metrics[k]), torch.tensor(w),
                                           rtol=1e-3, atol=1e-3, msg=f"dp {kind} {k}")
            got = _load_state(start, tensors, counts)
            serr, offs = smoke.compare_updated(cfg, start_cpu, got, state_ref, quiet=True)
            log(f"[dp] {kind} update B={TRAIN_BATCH} x {TRAIN_POINTS} on {where}: metrics "
                f"within 1e-3 of the update without a mesh, running statistics "
                f"max_abs_err={serr:.3e}, moves off " + ", ".join(
                    f"{g} {o}/{n}" for g, (o, n, _) in offs.items())
                + f"; every rank's state bit-identical; {ms:.3f} ms an update against "
                f"{ms_alone:.3f} ms without a mesh (host clock, median of 3); with the "
                f"collectives clocked {clocked_ms:.3f} ms, {coll_ms:.3f} of them in the "
                f"collectives ({coll_ms / clocked_ms:.1%}) ok ({card})")
    if mark:
        mark("dp updates")

    # the TrainConfig() iteration on the ranks: launches as phase 11's
    loops = [r["loop"] for r in ranks]
    horizon, updates = loops[0]["horizon"], loops[0]["updates"]
    want_collect = {k: PER_CALL[k] * horizon for k in smoke.wrappers}
    want_collect["contact_scan"] = RESET_K7 + STEP_K7 * horizon + RETRACT_K7
    want_train = {k: v * updates for k, v in DDPG_PER_UPDATE.items()}
    for r, lp in enumerate(loops):
        if lp["collect_counts"] != want_collect or lp["train_counts"] != want_train:
            raise AssertionError(f"dp loop rank {r}: launches {lp['collect_counts']} in "
                                 f"collect, {lp['train_counts']} in train_iter; expected "
                                 f"{want_collect}, {want_train} (phase 11's)")
        st = lp["stats"]
        bad = [k for k, v in {**st, **lp["metrics"]}.items() if not np.isfinite(v)]
        if st["buffer_idx"] <= 0 or lp["update_step"] != updates or bad:
            raise AssertionError(f"dp loop rank {r}: buffer_idx {st['buffer_idx']}, "
                                 f"update_step {lp['update_step']}, non-finite {bad}")
    per_rank = {k: loops[0]["collect_counts"][k] + loops[0]["train_counts"][k]
                for k in smoke.wrappers}
    smoke.per_dp_iter = per_rank
    it_ms = max(lp["collect_ms"] + lp["train_ms"] for lp in loops)
    envs = LOOP_ENVS * horizon
    log(f"[dp] TrainConfig() iteration at {LOOP_ENVS} envs on {DP_RANKS} ranks of one card "
        f"({LOOP_ENVS // DP_RANKS} envs a rank, batch {TRAIN_BATCH} x {TRAIN_POINTS}, "
        f"{updates} updates): set up {max(lp['setup_ms'] for lp in loops):.1f} ms; each rank's "
        f"launches per iteration {per_rank}, equal to phase 11's; the ring's point states "
        f"sharded, {loops[0]['buffer_bytes']} bytes a rank ({card})")
    for r, lp in enumerate(loops):
        log(f"[dp] rank {r}, its first (cold) iteration: collect "
            f"{collect_split(lp['spans'], lp['collect_ms'], horizon)}; train_iter "
            f"{lp['train_ms']:.3f} ms (host clock; {card})")
    log(f"[dp] iteration {it_ms:.3f} ms (the slower rank; cold, as phase 11's first), {envs} "
        f"env steps, {envs / max(lp['collect_ms'] for lp in loops) * 1e3:.1f} env steps/s over "
        f"both ranks; valid scenes {loops[0]['stats']['valid_scene_frac']:.4f}, buffer_idx "
        f"{loops[0]['stats']['buffer_idx']}: {DP_RANKS} ranks sharing one card measure the "
        f"parallel path's overhead, not a speedup ({card})")
    if mark:
        mark("dp loop")
    dp_image_checks(smoke, ranks, whole_image, whole_image_ms, alone_image, image_cfg,
                    image_start)
    if mark:
        mark("dp image")

    # the fast tier against one rank (tests/test_torch_dp_train.py's rules)
    n = one[0]["buffer_idx"]
    for r, (roll, ring, metrics, step, tensors) in enumerate(rank["fast"] for rank in ranks):
        for k in ("buffer_idx", "rollout_success", "valid_scene_frac"):
            if roll[k] != one[0][k]:
                raise AssertionError(f"dp fast tier rank {r}: {k} {roll[k]} against {one[0][k]}")
        for k in DP_RING_FIELDS:
            np.testing.assert_allclose(ring[k][:n], one[1][k][:n], atol=1e-5,
                                       err_msg=f"dp fast tier rank {r}: ring {k}")
        off = float(np.mean(np.abs(ring["action"][:n] - one[1]["action"][:n]) > 1e-4))
        med = float(np.median(np.abs(ring["point_state"][:n] - one[1]["point_state"][:n])))
        if off >= 0.25 or med >= 1e-4:
            raise AssertionError(f"dp fast tier rank {r}: {off:.0%} of action elements off, "
                                 f"point-state median {med:.3e}")
        if set(metrics) != set(one[2]) or step != one[3] or not all(
                np.array_equal(a, b) for a, b in zip(tensors, ranks[0]["fast"][4])):
            raise AssertionError(f"dp fast tier rank {r}: metrics, update_step or state")
    log(f"[dp] fast dry-run tier on {DP_RANKS} ranks against 1 rank on the card: buffer_idx "
        f"{n}, success and valid-scene share equal, ring fields within 1e-5, actions and "
        f"points within test_mesh.py's rules, finite metrics, update_step 1, every rank's "
        f"state bit-identical: DRYRUN_OK ranks={DP_RANKS} ok")
    fl = ranks[0]["flagship"]
    log(f"[dp] flagship dry-run tier (the planner, 2 clutter bodies, build_proc_library(2, "
        f"seed0=11)) on {DP_RANKS} ranks in {ranks[0]['flagship_s']:.1f} s: buffer_idx "
        f"{fl[0]['buffer_idx']}, finite metrics, update_step 1, every rank's state "
        f"bit-identical: DRYRUN_FLAGSHIP_OK ranks={DP_RANKS} ok")
    log(f"[dp] phase 16 took {time.perf_counter() - t_phase:.1f} s ({card})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale2-seeds", type=seed_range, metavar="A-B",
                    help="run phase 10's scale-2 DDPG update check alone, on the batches "
                         "of these seeds (the full run uses "
                         f"{','.join(map(str, SCALE2_SEEDS))}); also a list, as 5,17,27")
    ap.add_argument("--plain-on-card", default="", metavar="K5,K6",
                    help="with --scale2-seeds: these train kernels' plain versions run on "
                         "the card in place of the kernels, to tell which kernel's rounding "
                         "sets a card-vs-CPU event off")
    ap.add_argument("--k5-scale", type=lambda t: [float(x) for x in t.split(",")],
                    metavar="EPS,...",
                    help="the check's sensitivity: phase 10's update check with K5's pooled "
                         "output scaled by (1 + eps) on the card, for each eps, on the seeds "
                         "of --scale2-seeds (default: the full run's); reports the seeds the "
                         "nudge rule refuses")
    ap.add_argument("--loop", action="store_true",
                    help="run phase 11 (the train loop at full width and at B=8 card vs "
                         "CPU) alone")
    ap.add_argument("--clutter", action="store_true",
                    help="run phase 12 (the td3_clutter train iteration at full width, the "
                         "B=8 clutter path card vs CPU, physics/multi.py against K7) alone")
    ap.add_argument("--proc", action="store_true",
                    help="run phase 13 (the proc_shapenet:4 library, one TrainConfig() "
                         "iteration on it, cli.train_goal and the GoalFeature checks) alone")
    ap.add_argument("--image", action="store_true",
                    help="run phase 14 (the image-mode iteration at 1024 envs, the image agent's "
                         "timings, the B=8 image env, encoder and updates card vs CPU, the "
                         "export round trip, record_episode) alone")
    ap.add_argument("--cli", action="store_true",
                    help="run phase 15 (train_online, train_test_offline --test with the "
                         "policy and --expert, show_metrics, as child processes) alone")
    ap.add_argument("--dp", action="store_true",
                    help="run phase 16 (data-parallel training: K5/K6 split across 2 ranks "
                         "of the card, the sharded updates on 2 ranks and on 1 over NCCL, a "
                         "TrainConfig() iteration on 2 ranks, both dry-run tiers) alone")
    ap.add_argument("--planner", action="store_true",
                    help="run the CHOMP planner alone: phase 8's env path with EnvParams(), "
                         "plan_to_goal card vs CPU, the reset, step and retract times and "
                         "the minimal_rollout seed contract")
    args = ap.parse_args(argv)
    plain = [k for k in args.plain_on_card.split(",") if k]
    if any(k not in PLAIN_ON_CARD for k in plain) or (plain and not args.scale2_seeds):
        ap.error(f"--plain-on-card takes some of {', '.join(PLAIN_ON_CARD)}, "
                 "with --scale2-seeds")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gaddpg_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the gaddpg_tpu_torch package is missing ({e})", file=sys.stderr)
        return 1
    builds = []  # the library builds running beside the card's phases
    try:
        t_start = time.perf_counter()
        log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        card = card_line()
        t0 = time.perf_counter()
        build.build_all()
        log(f"[build] {len(build.KERNELS)} kernels built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, text in build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"[build] {name}: {line.strip()}")
        if args.k5_scale:
            Smoke().k5_scale_control(args.k5_scale, args.scale2_seeds or SCALE2_SEEDS)
            print(card, flush=True)
            return 0
        if args.loop:
            smoke = Smoke()
            smoke.loop_path()
            smoke.loop_card_vs_cpu()
            smoke.loop_card_vs_cpu(planner=True)
            print(card, flush=True)
            return 0
        if args.clutter:
            smoke = Smoke()
            clutter_phase(smoke, torch.Generator(device="cuda").manual_seed(12))
            print(card, flush=True)
            log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.proc:
            builds.append(LibraryBuild(PROC_INDEX, "alone"))
            proc_phase(Smoke(), torch.Generator(device="cuda").manual_seed(13), builds[-1])
            print(card, flush=True)
            log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.image or args.cli:
            smoke = Smoke()
            if args.image:
                image_phase(smoke)
            if args.cli:
                cli_phase(smoke)
            print(card, flush=True)
            log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.dp:
            builds.append(LibraryBuild(DP_FLAGSHIP, "beside phase 16's references"))
            dp_phase(Smoke(), torch.Generator(device="cuda").manual_seed(DP_SEED), builds[-1])
            print(card, flush=True)
            log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.planner:
            with torch.no_grad():
                smoke = Smoke()
                env = planner_env()
                env_gen = torch.Generator(device="cuda").manual_seed(7)
                stepped, _ = smoke.env_path(env, env_gen)
                smoke.plan_card_vs_cpu(env)
                smoke.env_call_times(env, env_gen, stepped)
                smoke.seed_contract()
            print(card, flush=True)
            log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.scale2_seeds:
            from gaddpg_tpu_torch.ops import sa_train

            for k in plain:
                kernel, reference = PLAIN_ON_CARD[k]
                setattr(sa_train, kernel, getattr(sa_train, reference))
                log(f"[learner] scale 2: {k}'s plain version on the card ({reference})")
            Smoke().scale2_card_vs_cpu(args.scale2_seeds)
            print(card, flush=True)
            return 0
        torch.manual_seed(0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        # phase 13's and phase 16's libraries, built on the host's CPU while
        # the card's phases run
        lib_build = LibraryBuild(PROC_INDEX, "beside phases 2-12")
        dp_build = LibraryBuild(DP_FLAGSHIP, "beside phases 2-15")
        builds += [lib_build, dp_build]
        with torch.no_grad():  # serving: no autograd graph anywhere
            smoke = Smoke()
            smoke.check_kernels(gen)
            smoke.check_fps(gen)
            smoke.check_ball_query(torch.Generator(device="cuda").manual_seed(K2_SEED))
            smoke.check_valid_masks(gen)
            smoke.check_k4(gen)
        smoke.check_train_kernels(gen)  # gradients: outside no_grad
        smoke.check_compaction(gen)
        with torch.no_grad():
            select, inputs = smoke.main_path(gen)
            smoke.runner()
            totals = smoke.timings(select, inputs, gen)
        mark = lambda name: log(f"[phase] {name} done at "  # noqa: E731
                                f"{time.perf_counter() - t_start:.1f} s")
        mark("serving")
        smoke.learner(gen)
        totals.update(smoke.train_timings(gen))
        smoke.scale2_timings(gen)
        mark("learner")
        smoke.bf16_path(gen)
        mark("bf16")
        with torch.no_grad():
            from gaddpg_tpu_torch.envs.assets import library_from_index
            from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv

            lib = library_from_index("ycb", "train")
            env = planner_env(lib)  # EnvParams(): the CHOMP expert, device="cuda"
            # the goal servo's env for K7's live states and phase 9
            servo = PandaGraspEnv(EnvParams(use_planner=False), lib)
            servo_cpu = PandaGraspEnv(EnvParams(use_planner=False), lib, device="cpu")
            env_gen = torch.Generator(device="cuda").manual_seed(7)
            smoke.check_contact_scan(servo, env_gen)
            mark("K7")
            stepped, stepped_obs = smoke.env_path(env, env_gen)
            smoke.plan_card_vs_cpu(env)
            totals["contact_scan"] = smoke.env_timings(env, env_gen, stepped)
            smoke.seed_contract()
            mark("env and planner")
            smoke.cloud_timings(stepped_obs.point_state)
            smoke.env_card_vs_cpu(servo, servo_cpu)
            mark("env card vs CPU")
        smoke.scale2_card_vs_cpu()
        mark("scale 2")
        smoke.per_iter = smoke.loop_path()
        smoke.loop_run = None
        mark("loop")
        smoke.loop_card_vs_cpu()
        smoke.loop_card_vs_cpu(planner=True)
        mark("loop card vs CPU")
        clutter_phase(smoke, gen, mark, profile=False)
        proc_phase(smoke, gen, lib_build, mark)
        image_phase(smoke, mark)
        cli_phase(smoke, mark)
        dp_phase(smoke, gen, dp_build, mark)
        line = smoke.kernel_line(totals)
    except Exception:  # report which phase failed, then fail the run
        traceback.print_exc()
        return 1
    finally:
        for build_proc in builds:
            build_proc.stop()
    log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
