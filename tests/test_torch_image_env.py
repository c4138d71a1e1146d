"""Image mode of the env: `render_rgbdm` (gaddpg_tpu_torch/render/camera.py)
and the RGBDM observation of `PandaGraspEnv(use_image=True,
domain_rand=True)` against the JAX package, and the domain-randomisation
contract of tests/test_image_mode.py.

The env is held image by image: each observation of the port's own reset
and steps, made with the JAX package's draws (the visual seed, the look
that JAX derives from PRNGKey(vis_seed), the pixel noise of
fold_in(key, env_step)), against the JAX `_observe` of the same state.
The state's own evolution is held to JAX by tests/test_torch_env.py. On
the same points and poses the z-buffer is exact (a minimum over the same
values), so the mask is equal bit for bit, and so is `render_rgbdm`'s
depth; RGB agrees to float32 rounding (1e-6).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs.assets import box_asset as jax_box_asset
from gaddpg_tpu.render import camera as jax_camera
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv, domain_look
from gaddpg_tpu_torch.render import camera
from torch_env_common import jax_state, make_envs
from torch_image_common import S

B = 3
RGB = 1e-6
# the env's occluders (table plane, gripper boxes, arm spheres) are
# ray-cast analytically, through small products summed in another order
# than XLA's: depth within 1e-5 there [2.9e-6], RGB within RGB [3.0e-7]
ENV_TOL = (1e-5, RGB)
CAM = camera.CameraParams(width=S, height=S)
SEEDS = (0, 1, 2)


def _look_draws(vis_seed, env_step):
    """The JAX package's look and pixel noise for each env's visual seed
    and step (gaddpg_tpu/envs/grasp_env.py:330-340), as draws."""
    out = {k: [] for k in ("albedo", "occluder_color", "light_gain", "image_noise")}
    for seed, step in zip(np.asarray(vis_seed), np.asarray(env_step)):
        ka, ko, kl, kn = jax.random.split(jax.random.PRNGKey(int(seed)), 4)
        out["albedo"].append(jax.random.uniform(ka, (3,), minval=0.1, maxval=0.95))
        out["occluder_color"].append(jax.random.uniform(ko, (3,), minval=0.15, maxval=0.85))
        out["light_gain"].append(jax.random.uniform(kl, (), minval=0.6, maxval=1.4))
        out["image_noise"].append(jax.random.normal(jax.random.fold_in(kn, int(step)), (3, S, S)))
    return {k: torch.as_tensor(np.stack([np.asarray(x) for x in v])) for k, v in out.items()}


def _assert_rgbdm_equal(got, want, depth_tol=0.0, rgb_tol=RGB):
    """Mask bit for bit, depth within depth_tol (0: bit for bit), RGB
    within rgb_tol."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=depth_tol)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=rgb_tol)


@pytest.mark.parametrize("rand", [False, True], ids=["plain", "domain_rand"])
def test_render_rgbdm_matches_jax(rand):
    """B views of a cloud of surface points behind a partial occluder
    (a tilted plane over part of the image, +inf elsewhere)."""
    rng = np.random.RandomState(3 + rand)
    pts = np.concatenate([rng.uniform(-0.08, 0.08, (B, 400, 2)),
                          rng.uniform(0.25, 0.35, (B, 400, 1))], -1).astype(np.float32)
    inv = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    inv[:, :3, 3] = rng.uniform(-0.02, 0.02, (B, 3))
    ramp = 0.27 + 0.06 * np.linspace(0, 1, S, dtype=np.float32)[None, None, :]
    occ = np.where(np.arange(S)[None, :, None] < S // 2, ramp, np.inf).astype(np.float32)
    occ = np.broadcast_to(occ, (B, S, S)).copy()
    albedo = rng.uniform(0.1, 0.95, (B, 3)).astype(np.float32)
    kw_j, kw_p = [{} for _ in range(B)], {}
    if rand:
        oc = rng.uniform(0.15, 0.85, (B, 3)).astype(np.float32)
        gain = rng.uniform(0.6, 1.4, B).astype(np.float32)
        keys = [jax.random.PRNGKey(10 + i) for i in range(B)]
        noise = np.stack([np.asarray(jax.random.normal(k, (3, S, S))) for k in keys])
        kw_j = [dict(occluder_color=oc[i], light_gain=gain[i], noise_key=keys[i],
                     noise_std=0.02) for i in range(B)]
        kw_p = dict(occluder_color=torch.from_numpy(oc), light_gain=torch.from_numpy(gain),
                    noise=torch.from_numpy(noise), noise_std=0.02)
    want = np.stack([np.asarray(jax_camera.render_rgbdm(CAM, inv[i], pts[i], albedo[i],
                                                        occ_depth=occ[i], **kw_j[i]))
                     for i in range(B)])
    got = camera.render_rgbdm(CAM, torch.from_numpy(inv), torch.from_numpy(pts),
                              torch.from_numpy(albedo), occ_depth=torch.from_numpy(occ), **kw_p)
    _assert_rgbdm_equal(got.numpy(), want)
    # every kind of pixel is present: target, occluded target, background
    mask, depth = want[:, 4], want[:, 3]
    assert (mask == 0).any() and ((mask == 1) & (depth > 0)).any() and (depth == 0).any()


@pytest.fixture(scope="module")
def envs():
    params = dict(camera=CAM, use_image=True, domain_rand=True, reset_tries=1, use_planner=False)
    return make_envs(jax_box_asset(0.06, 0.06, 0.14), JaxEnvParams(**params), EnvParams(**params))


@functools.lru_cache(maxsize=None)
def _jax_observe(jenv):
    return jax.jit(jax.vmap(jenv._observe))


def _jax_images(jenv, state, env_step):
    """The JAX `_observe` images of a port state, observed at `env_step`."""
    js = jax_state(dataclasses.replace(state, env_step=env_step))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    return np.asarray(_jax_observe(jenv)(js, keys)[1].image)


def test_image_env_reset_and_steps_match_jax(envs):
    """Reset (the visual seeds JAX's reset_scene draws, fold_in(key, 23))
    and 2 expert steps of the goal-servo env, every observation's image
    against the JAX `_observe` of the same state."""
    jenv, env = envs
    gen = torch.Generator().manual_seed(5)
    scene = env.sample_scene(B, gen)
    vis_seed = np.array([jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(100 + s), 23),
                                            (), 0, jnp.iinfo(jnp.int32).max) for s in SEEDS])
    zero = torch.zeros(B, dtype=torch.int32)
    draws = {"keep_u": torch.rand((B, env.p.new_points_per_step), generator=gen),
             "idx": torch.zeros((B, env.p.uniform_num_pts), dtype=torch.int64),
             "vis_seed": torch.as_tensor(vis_seed), **_look_draws(vis_seed, zero)}
    st, obs = env.reset_scene(scene, draws=draws)
    np.testing.assert_array_equal(st.vis_seed.numpy(), vis_seed)
    assert obs.image.shape == (B, 5, S, S) and (obs.image[:, 4] == 0).any()
    _assert_rgbdm_equal(obs.image.numpy(), _jax_images(jenv, st, st.env_step), *ENV_TOL)
    for _ in range(2):
        step_draws = dict(draws, **_look_draws(vis_seed, st.env_step))
        before = st.env_step
        st, obs, _, _, _ = env.step_batched(st, env.expert_action(st), draws=step_draws)
        _assert_rgbdm_equal(obs.image.numpy(), _jax_images(jenv, st, before), *ENV_TOL)
    assert (st.env_step == 2).all()


def test_vis_seed_contract():
    """tests/test_image_mode.py's TestDomainRandomization, in the port: the
    same generator seed gives the same image; another visual seed on the
    same scene changes RGB by more than 0.05 and leaves depth and mask bit
    for bit; without domain_rand the visual seed changes nothing. The
    look of a seed is one integer hash, so it does not depend on the
    device or the batch."""
    params = EnvParams(camera=CAM, use_image=True, domain_rand=True, reset_tries=1,
                       use_planner=False)
    env = PandaGraspEnv(params, box_asset(0.06, 0.06, 0.14), device="cpu")
    state, obs = env.reset(2, torch.Generator().manual_seed(4))
    _, obs2 = env.reset(2, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(obs.image.numpy(), obs2.image.numpy())

    def reobserve(e, seed):
        st = dataclasses.replace(state, vis_seed=torch.full_like(state.vis_seed, seed))
        return e._observe_impl(st, torch.Generator().manual_seed(7))[1].image

    a, b = reobserve(env, 111), reobserve(env, 222)
    assert float((a[:, :3] - b[:, :3]).abs().max()) > 0.05
    np.testing.assert_array_equal(a[:, 3:].numpy(), b[:, 3:].numpy())
    plain = PandaGraspEnv(dataclasses.replace(params, domain_rand=False), env.lib, device="cpu")
    np.testing.assert_array_equal(reobserve(plain, 1).numpy(), reobserve(plain, 2).numpy())

    seeds = torch.tensor([0, 1, 111, 2**31 - 2])
    look = domain_look(seeds)
    for part, row in zip(look, domain_look(seeds[2:3])):
        np.testing.assert_array_equal(part[2:3].numpy(), row.numpy())
    albedo, occluder, gain = (x.numpy() for x in look)
    assert (0.1 <= albedo).all() and (albedo <= 0.95).all()
    assert (0.15 <= occluder).all() and (occluder <= 0.85).all()
    assert (0.6 <= gain).all() and (gain <= 1.4).all()
    assert len({tuple(r) for r in albedo}) == len(seeds)
