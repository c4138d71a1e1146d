"""The CLIs and visual utilities of the port (gaddpg_tpu_torch/cli/,
utils/video.py, utils/recording.py): `show_metrics.summarize`,
`rgbdm_to_rgb`, `write_strip`, `write_video` and `EpisodeRecorder` give
what the JAX package's give on the same files and arrays; `train_online`
and `train_test_offline` run end to end on the CPU at the smallest sizes
a YAML allows; `record_episode` records an image episode."""

import json
import os

import numpy as np
import pytest
import torch

from gaddpg_tpu.cli import show_metrics as jax_show_metrics
from gaddpg_tpu.utils import recording as jax_recording
from gaddpg_tpu.utils import video as jax_video
from gaddpg_tpu_torch.cli import show_metrics, train_online, train_test_offline
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from gaddpg_tpu_torch.utils import recording, video

# experiments/cfgs/td3_critic_aux_policy_aux.yaml's switches at the
# smallest sizes: 4 envs, a 3-step horizon (+6), 1 update of batch 4, the
# goal servo in place of the planner
TINY_YAML = """\
RL_MEMORY_SIZE: 256
RL_MAX_STEP: 3
use_planner: False
reset_tries: 1
RL_TRAIN:
  RL: True
  dagger: True
  batch_size: 4
  updates_per_step: 1
  num_remotes: 4
  explore_ratio_list: [0.5]
  onpolicy: True
  online_buffer_ratio: 1.0
  mix_policy_ratio_list: [0.1]
  index_file: ycb
"""


def _frames(seed, count=5, s=8):
    rng = np.random.RandomState(seed)
    f = rng.uniform(-0.1, 1.1, (count, 5, s, s)).astype(np.float32)
    f[:, 3] = rng.uniform(0.0, 0.5, (count, s, s))
    f[:, 4] = rng.uniform(0, 1, (count, s, s)) > 0.5
    return f


def test_show_metrics_matches_jax(tmp_path, capsys):
    recs = [{"step": i, "wall": 0.5 * i, "critic_loss": 1.0 / (i + 1), "bc_loss": 0.1 * i}
            for i in range(60)]
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for i, r in enumerate(recs):
            f.write(json.dumps(r) + "\n")
            if i == 30:
                f.write("not json\n")
    assert show_metrics.summarize(str(tmp_path)) == jax_show_metrics.summarize(str(tmp_path))
    assert show_metrics.summarize(str(tmp_path / "none")) is None
    show_metrics.main([str(tmp_path), "--keys", "bc_loss"])
    out = capsys.readouterr().out
    jax_show_metrics.main([str(tmp_path), "--keys", "bc_loss"])
    assert out == capsys.readouterr().out and "bc_loss" in out and "critic_loss" not in out


def test_video_writers_match_jax(tmp_path):
    """The picture of each frame, the PNG strip and the GIF, byte for byte."""
    frames = _frames(0, count=11)
    for f in frames:
        np.testing.assert_array_equal(video.rgbdm_to_rgb(f), jax_video.rgbdm_to_rgb(f))
    for name, writer, jax_writer in (("strip.png", video.write_strip, jax_video.write_strip),
                                     ("clip.gif", video.write_video, jax_video.write_video)):
        got, want = str(tmp_path / "port" / name), str(tmp_path / "jax" / name)
        writer(frames, got)
        jax_writer(frames, want)
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read(), name


def test_episode_recorder_matches_jax(tmp_path):
    """The same port states and observations (CPU tensors) through both
    recorders give the same .npz."""
    env = PandaGraspEnv(EnvParams(camera=CameraParams(width=16, height=16), use_planner=False,
                                  reset_tries=1), box_asset(0.06, 0.06, 0.14), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(2, gen)
    recs = (recording.EpisodeRecorder(), jax_recording.EpisodeRecorder())
    for t in range(2):
        action = env.expert_action(state)
        for rec in recs:
            rec.add(state, obs, action, extra={"t": torch.tensor(float(t))})
        state, obs, _, _, _ = env.step_batched(state, action, gen)
    paths = [str(tmp_path / f"{k}.npz") for k in ("port", "jax")]
    for rec, path in zip(recs, paths):
        assert len(rec) == 2
        rec.save(path)
    got, want = np.load(paths[0]), np.load(paths[1])
    assert set(got.files) == set(want.files) and "joints" in got.files
    for k in got.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_record_episode_renders_rgbdm():
    """An expert episode at B=1 on a point-cloud env: record_episode turns
    rendering on and returns finite (T, 5, H, W) frames."""
    env = PandaGraspEnv(EnvParams(physics=PhysicsParams(substeps=10),
                                  camera=CameraParams(width=16, height=16), use_planner=False,
                                  settle_substeps=20, reset_tries=1, max_steps=3,
                                  retract_lift_steps=2), box_asset(0.06, 0.06, 0.14),
                        device="cpu")
    frames, reward, infos = video.record_episode(env, None, None, torch.Generator().manual_seed(1),
                                                 max_steps=3, obj_idx=0)
    assert frames.shape[1:] == (5, 16, 16) and 2 <= len(frames) <= 4
    assert len(infos) == len(frames) - 1 and np.isfinite(frames).all()
    assert reward in (0.0, 1.0) and (frames[:, 4] == 0).any()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(config path, log dir) after `train_online --max_iters 1` on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    log_dir = root / "run"
    trainer = train_online.main(["--config_file", str(cfg), "--policy", "DDPG", "--max_iters",
                                 "1", "--log_dir", str(log_dir), "--device", "cpu"])
    assert trainer.update_step == 1
    return str(cfg), str(log_dir)


def test_train_online_writes_its_outputs(trained):
    _, log_dir = trained
    assert {"config.json", "metrics.jsonl", "agent_latest.pt"} <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["num_envs"] == 4 and cfg["onpolicy"] and cfg["dagger"]
    summary = show_metrics.summarize(log_dir)
    assert summary["step"] == 1 and np.isfinite(summary["critic_loss"])
    assert summary["rollout_time"] > 0 and summary["train_time"] > 0


def test_train_test_offline_reloads_the_checkpoint(trained, capsys, tmp_path):
    """test_ycb.sh's evaluator on the checkpoint, one wave of 4 episodes
    (`--expert` runs the same evaluation with the expert's actions)."""
    cfg, log_dir = trained
    rate = train_test_offline.main(["--test", "--config_file", cfg, "--pretrained", log_dir,
                                    "--num_runs", "1", "--episodes", "4", "--log_dir",
                                    str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"loaded {log_dir} @ step 1" in out and "overall:" in out
    assert 0.0 <= rate <= 1.0
