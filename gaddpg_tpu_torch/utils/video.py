"""Rollout video and visual observability (counterpart of
gaddpg_tpu/utils/video.py; reference: core/utils.py:370-406 write_video,
core/train_online.py:276-282).

An episode recorded as RGBDM frames becomes a GIF/MP4 or a tiled PNG
strip. The frames come from the env's own `render_rgbdm` on its device;
turning them into pictures is host numpy, and `imageio` is imported
only inside the writers.
"""

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch


def rgbdm_to_rgb(frame: np.ndarray) -> np.ndarray:
    """(5, H, W) RGBDM -> (H, 3 W, 3) uint8: RGB, then depth (near is
    bright) and the target mask (white) as side panels."""
    rgb = np.clip(np.asarray(frame[:3], np.float32), 0, 1)
    rgb = (np.transpose(rgb, (1, 2, 0)) * 255).astype(np.uint8)
    d = np.asarray(frame[3], np.float32)
    lo, hi = 0.0, max(float(d.max()), 1e-6)
    dn = ((1.0 - np.clip((d - lo) / (hi - lo), 0, 1)) * 255).astype(np.uint8)
    depth_rgb = np.stack([dn, dn, dn], axis=-1)
    mask = (np.asarray(frame[4]) == 0).astype(np.uint8) * 255
    mask_rgb = np.stack([mask, mask, mask], axis=-1)
    return np.concatenate([rgb, depth_rgb, mask_rgb], axis=1)


def _pictures(frames):
    return [rgbdm_to_rgb(f) if np.asarray(f).ndim == 3 and np.asarray(f).shape[0] == 5
            else np.asarray(f) for f in frames]


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 6):
    """Frames (T, 5, H, W) RGBDM (or (T, H, W, 3) uint8) -> a GIF (no
    native encoder needed) or, with an ffmpeg backend, an MP4."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = _pictures(frames)
    if path.endswith(".gif"):
        imageio.mimsave(path, imgs, duration=int(1000 / fps), loop=0)
    else:
        imageio.mimsave(path, imgs, fps=fps)
    return path


def write_strip(frames: Sequence[np.ndarray], path: str, max_frames: int = 8):
    """An episode's frames, at most `max_frames` evenly picked, stacked
    into one PNG."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fr = list(frames)
    if len(fr) > max_frames:
        idx = np.linspace(0, len(fr) - 1, max_frames).astype(int)
        fr = [fr[i] for i in idx]
    imageio.imwrite(path, np.concatenate(_pictures(fr), axis=0))
    return path


@torch.no_grad()
def record_episode(env, agent_state, select_action, generator=None, scene=None,
                   max_steps: int = 24, use_image_policy: bool = False, obj_idx=None):
    """Roll one episode (B = 1) with RGBDM rendering on -> (frames
    (T, 5, H, W) numpy, lift reward, [per-step info]).

    `env` may be any PandaGraspEnv: a copy with `use_image` on renders the
    frames. `select_action` None rolls the expert, else the policy
    (`make_select_action`'s function) on the image (`use_image_policy`)
    or the point state. The episode resets from `scene` (a one-scene
    dict, `reset_scene`) or randomly (`obj_idx` fixes the object), steps
    through the per-env `step` until done or `max_steps`, then retracts.
    Draws come from `generator`."""
    from gaddpg_tpu_torch.envs.grasp_env import PandaGraspEnv

    p = env.p if env.p.use_image else dataclasses.replace(env.p, use_image=True)
    venv = PandaGraspEnv(p, env.lib, device=env.device)
    if scene is not None:
        state, obs = venv.reset_scene(scene, generator)
    else:
        state, obs = venv.reset(1, generator, obj_idx=obj_idx)
    frames, infos = [obs.image[0].cpu().numpy()], []
    for t in range(max_steps):
        if select_action is None:
            action = venv.expert_action(state)
        else:
            inp = obs.image if use_image_policy else obs.point_state
            remain = torch.full((1,), float(max_steps - t), device=venv.device)
            action, _ = select_action(agent_state, inp, remain)
        state, obs, _, done, info = venv.step(state, action, generator)
        frames.append(obs.image[0].cpu().numpy())
        infos.append({k: float(v[0]) for k, v in info.items()})
        if bool(done[0]):
            break
    _, reward = venv.retract(state)
    return np.stack(frames), float(reward[0]), infos
