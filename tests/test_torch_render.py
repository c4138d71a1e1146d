"""The wrist-camera functions and the point-cloud reservoir of the port
against the JAX package, on identical float32 inputs from seeded numpy
and identical random draws (taken from `jax.random` and injected).

Bounds: which pixels are hit, and the compaction order, are equal; depth
values and points within 1e-6 (float32 rounding of the pose transforms,
summed in another order by the two matrix products), the sphere
occluders' depths within 1e-6 + 1e-4 relative (near grazing rays, see
the test); the reservoir's labels, count and cursor equal and its points
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.render import camera as jcam
from gaddpg_tpu.render import pointcloud as jpc
from gaddpg_tpu.geometry.se3 import se3_from_quat_pos as jse3_from_quat_pos
from gaddpg_tpu.geometry.se3 import se3_inverse as jse3_inverse
from gaddpg_tpu_torch.render import camera, pointcloud

CAM = camera.CameraParams(width=64, height=64)
JCAM = jcam.CameraParams(width=64, height=64)
B = 3


def _t(x):
    return torch.as_tensor(np.array(x))


def _poses(seed):
    """Camera poses looking down at a 10 cm box of surface points 0.3 m
    below, with some tilt, and the points."""
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-0.3, 0.3, (B, 3))
    q = np.concatenate([np.ones((B, 1)), 0.5 * ang], axis=1)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    # optical axis (+z) points down: rotate by pi about x
    flip = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    from gaddpg_tpu.geometry.rotations import quat_mul
    q = np.asarray(quat_mul(jnp.asarray(q), jnp.asarray(flip)))
    t = np.concatenate([rng.uniform(-0.05, 0.05, (B, 2)), np.full((B, 1), 0.35)], 1)
    cam = np.asarray(jax.vmap(jse3_from_quat_pos)(q, t.astype(np.float32)))
    pts = rng.uniform(-0.05, 0.05, (B, 600, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 0.02
    return cam, np.asarray(jax.vmap(jse3_inverse)(cam)), pts


@pytest.fixture(scope="module")
def scene():
    return _poses(0)


def _close(port, ref, tol=1e-6, rtol=0.0):
    ref = np.asarray(ref)
    port = port.numpy()
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], atol=tol, rtol=rtol)


def test_render_depth_points_matches(scene):
    _, cam_inv, pts = scene
    ref = jax.vmap(lambda c, p: jcam.render_depth_points(JCAM, c, p))(cam_inv, pts)
    out = camera.render_depth_points(CAM, _t(cam_inv), _t(pts))
    np.testing.assert_array_equal(out.numpy() > 0, np.asarray(ref) > 0)
    assert (out > 0).sum() > 200
    _close(out, ref)


@pytest.mark.parametrize("which", ["plane", "box", "spheres"])
def test_analytic_occluders_match(scene, which):
    cam, _, _ = scene
    rng = np.random.RandomState(1)
    if which == "plane":
        ref = jax.vmap(lambda c: jcam.plane_zdepth(JCAM, c, 0.01))(cam)
        out = camera.plane_zdepth(CAM, _t(cam), 0.01)
    elif which == "box":
        q = rng.randn(B, 4).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = (rng.uniform(-0.03, 0.03, (B, 3)) + [0, 0, 0.2]).astype(np.float32)
        box = np.asarray(jax.vmap(jse3_from_quat_pos)(q, t))
        he = (0.031, 0.10, 0.028)
        ref = jax.vmap(lambda c, bx: jcam.box_zdepth(JCAM, c, bx, he))(cam, box)
        out = camera.box_zdepth(CAM, _t(cam), _t(box), he)
    else:
        centers = (rng.uniform(-0.1, 0.1, (B, 12, 3)) + [0, 0, 0.15]).astype(np.float32)
        radii = rng.uniform(0.02, 0.06, 12).astype(np.float32)
        ref = jax.vmap(lambda c, x: jcam.spheres_zdepth(JCAM, c, x, radii))(cam, centers)
        out = camera.spheres_zdepth(CAM, _t(cam), _t(centers), _t(radii))
    assert np.isfinite(np.asarray(ref)).any()
    # a ray's nearer root -(b + sqrt(disc)) / 2a moves by d(disc) / (4a
    # sqrt(disc)): near grazing incidence the last-bit difference of the
    # two matrix products behind b grows without bound, so the sphere
    # depths hold 1e-6 plus 1e-4 of the depth (measured: 1.2e-5 of it)
    _close(out, ref, rtol=1e-4 if which == "spheres" else 0.0)


def test_visible_depth_and_backprojection_match(scene):
    cam, cam_inv, pts = scene
    occ = np.asarray(jax.vmap(lambda c: jcam.plane_zdepth(JCAM, c, 0.045))(cam))
    ref = jax.vmap(lambda c, p, o: jcam.visible_target_depth(JCAM, c, p, occ_depth=o))(
        cam_inv, pts, occ)
    out = camera.visible_target_depth(CAM, _t(cam_inv), _t(pts), occ_depth=_t(occ))
    np.testing.assert_array_equal(out.numpy() > 0, np.asarray(ref) > 0)
    _close(out, ref)
    # compaction of the same depth image: equal order, points within 1e-6
    depth = np.asarray(ref)
    for max_points in (512, 64):  # 64 < hits: the overflow is dropped
        pref, vref = jax.vmap(lambda d: jcam.depth_to_points(JCAM, d, max_points))(depth)
        pout, vout = camera.depth_to_points(CAM, _t(depth), max_points)
        np.testing.assert_array_equal(vout.numpy(), np.asarray(vref))
        v = np.asarray(vref)
        np.testing.assert_allclose(pout.numpy()[v], np.asarray(pref)[v], atol=1e-6, rtol=0)
    assert vout.all() and v.sum() == B * 64


def test_accumulate_and_build_point_state_match():
    """Three steps of insertion into a 2048-point ring (the third wraps),
    each with the JAX keep-uniforms, then the policy state from the JAX
    resample indices."""
    rng = np.random.RandomState(2)
    cap, n = 2048, 512
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = [jpc.create_pc_state(cap) for _ in range(B)]
    state = pointcloud.create_pc_state(B, cap)
    # start the ring near its end so that the writes wrap
    state.cursor[:] = torch.tensor([0, 1900, 2047], dtype=torch.int32)
    state.count[:] = torch.tensor([0, 1900, 4000], dtype=torch.int32)
    jstate = [s.replace(cursor=jnp.int32(c), count=jnp.int32(k))
              for s, c, k in zip(jstate, (0, 1900, 2047), (0, 1900, 4000))]
    for step in range(3):
        new = rng.uniform(-0.1, 0.1, (B, n, 3)).astype(np.float32)
        valid = rng.rand(B, n) < 0.8
        ks = [jax.random.fold_in(k, step) for k in keys]
        keep_u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in ks])
        env_step = np.array([step, step + 3, step + 10], np.int32)
        jstate = [jpc.accumulate_points(s, k, jnp.asarray(x), jnp.asarray(v), jnp.int32(e))
                  for s, k, x, v, e in zip(jstate, ks, new, valid, env_step)]
        state = pointcloud.accumulate_points(state, _t(keep_u), _t(new), _t(valid),
                                             _t(env_step))
    for i in range(B):
        np.testing.assert_array_equal(state.labels[i].numpy(), np.asarray(jstate[i].labels))
        np.testing.assert_array_equal(state.points[i].numpy(), np.asarray(jstate[i].points))
        assert int(state.count[i]) == int(jstate[i].count)
        assert int(state.cursor[i]) == int(jstate[i].cursor)

    q = np.array([[1.0, 0.1, -0.2, 0.05]] * B, np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ef_inv = np.asarray(jax.vmap(jse3_inverse)(jax.vmap(jse3_from_quat_pos)(
        q, np.full((B, 3), 0.1, np.float32))))
    refs, idx = [], []
    for i, k in enumerate(keys):
        nv = int(jnp.maximum(jpc.num_valid(jstate[i]), 1))
        idx.append(np.asarray(jax.random.randint(k, (1024,), 0, nv)))
        refs.append(jpc.build_point_state(jstate[i], k, jnp.asarray(ef_inv[i])))
    out, n_target = pointcloud.build_point_state(state, _t(np.stack(idx)).long(), _t(ef_inv))
    for i, (ps, nt) in enumerate(refs):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ps), atol=1e-6, rtol=0)
        assert int(n_target[i]) == int(nt)


def test_empty_reservoir_point_state():
    state = pointcloud.create_pc_state(2, 2048)
    out, n_target = pointcloud.build_point_state(state, torch.zeros(2, 1024, dtype=torch.long),
                                                 torch.eye(4).repeat(2, 1, 1))
    ref, nt = jpc.build_point_state(jpc.create_pc_state(2048), jax.random.PRNGKey(0),
                                    jnp.eye(4))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref))
    assert int(n_target[0]) == int(nt) == 0
