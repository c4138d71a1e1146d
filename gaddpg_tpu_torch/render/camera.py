"""Point-splat depth camera with analytic occluders (counterpart of
gaddpg_tpu/render/camera.py).

Camera model of the reference wrist camera: 90-degree FOV, near 0.035 /
far 2.0 (reference: env/panda_scene.py:838-847); +z optical axis forward,
+x right, +y down (pinhole). The target is z-buffered from its surface
points (`scatter_reduce(..., "amin")`), while the table plane, the
gripper boxes and the arm's skeleton spheres are ray-cast analytically
per pixel. Every function takes a batch: poses (B, 4, 4), points
(B, N, 3), images (B, H, W).
"""

import dataclasses
import math

import torch

from gaddpg_tpu_torch.utils.constants import const


@dataclasses.dataclass(frozen=True)
class CameraParams:
    width: int = 112
    height: int = 112
    fov_deg: float = 90.0
    near: float = 0.035
    far: float = 2.0

    @property
    def focal(self) -> float:
        return self.width / 2.0 / math.tan(math.radians(self.fov_deg) / 2.0)


# a target point touching an occluder surface (finger pad on the object)
# sits numerically on it; keep such points visible
OCCLUSION_EPS = 2e-3


def _apply(T, pts):
    """Rigid transform(s) T (B, 4, 4) applied to points (B, N, 3)."""
    return pts @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def render_depth_points(cam: CameraParams, cam_pose_inv, points_world, valid=None):
    """Z-buffer world points into depth images (B, H, W), 0 = no hit.

    cam_pose_inv (B, 4, 4) world -> camera; points_world (B, N, 3);
    valid (B, N) bool, optional: only those points are drawn."""
    h, w = cam.height, cam.width
    b = points_world.shape[0]
    p_cam = _apply(cam_pose_inv, points_world)
    z = p_cam[..., 2]
    ok = (z > cam.near) & (z < cam.far)
    if valid is not None:
        ok = ok & valid
    f = cam.focal
    u = torch.round(f * p_cam[..., 0] / z + w / 2.0 - 0.5).to(torch.int64)
    v = torch.round(f * p_cam[..., 1] / z + h / 2.0 - 0.5).to(torch.int64)
    ok = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = torch.where(ok, v * w + u, h * w)  # out-of-view points land in a spare slot
    rows = torch.arange(b, device=z.device)[:, None] * (h * w + 1)
    depth = torch.full((b * (h * w + 1),), math.inf, dtype=z.dtype, device=z.device)
    depth = depth.scatter_reduce(0, (rows + flat).reshape(-1),
                                 torch.where(ok, z, math.inf).reshape(-1), "amin")
    depth = depth.reshape(b, h * w + 1)[:, : h * w]
    depth = torch.where(torch.isinf(depth), 0.0, depth)
    return depth.reshape(b, h, w)


def _pixel_dirs(cam: CameraParams, device):
    """Camera-frame ray directions (H*W, 3) with z = 1, so the ray
    parameter is the pinhole z-depth."""
    h, w = cam.height, cam.width
    f = cam.focal
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5 - w / 2.0) / f
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5 - h / 2.0) / f
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=-1).reshape(-1, 3)


def _world_dirs(cam, cam_pose):
    return _pixel_dirs(cam, cam_pose.device) @ cam_pose[:, :3, :3].transpose(-1, -2)


def plane_zdepth(cam: CameraParams, cam_pose, z_plane: float = 0.0):
    """Per-pixel z-depth (B, H, W) of each ray's hit on the world plane
    z == z_plane; +inf where it misses. cam_pose (B, 4, 4) camera -> world."""
    d_z = _world_dirs(cam, cam_pose)[..., 2]                 # (B, HW)
    o_z = cam_pose[:, 2, 3][:, None]
    par = torch.abs(d_z) > 1e-8
    t = (z_plane - o_z) / torch.where(par, d_z, 1e-8)
    t = torch.where((t > cam.near) & (t < cam.far) & par, t, math.inf)
    return t.reshape(-1, cam.height, cam.width)


def box_zdepth(cam: CameraParams, cam_pose, box_pose, half_extents):
    """Per-pixel z-depth (B, H, W) of each ray's hit on an oriented box
    (slab test), +inf where it misses. box_pose (B, 4, 4)."""
    dirs_w = _world_dirs(cam, cam_pose)
    r = box_pose[:, :3, :3]
    o_b = (r.transpose(-1, -2) @ (cam_pose[:, :3, 3] - box_pose[:, :3, 3])[..., None])[..., 0]
    d_b = dirs_w @ r                                          # (B, HW, 3)
    he = const(tuple(half_extents), dirs_w.device, dirs_w.dtype)
    d_safe = torch.where(torch.abs(d_b) > 1e-8, d_b, 1e-8)
    t1 = (-he - o_b[:, None, :]) / d_safe
    t2 = (he - o_b[:, None, :]) / d_safe
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=cam.near)) & (tmin < cam.far)
    t = torch.where(hit, torch.clamp(tmin, min=cam.near), math.inf)
    return t.reshape(-1, cam.height, cam.width)


def spheres_zdepth(cam: CameraParams, cam_pose, centers, radii):
    """Per-pixel nearest z-depth (B, H, W) over spheres centers (B, N, 3)
    with radii (N,) or (B, N); +inf where every ray misses."""
    dirs_w = _world_dirs(cam, cam_pose)                       # (B, HW, 3)
    oc = cam_pose[:, None, :3, 3] - centers                   # (B, N, 3)
    a = torch.sum(dirs_w * dirs_w, dim=-1)                    # (B, HW)
    bq = 2.0 * dirs_w @ oc.transpose(-1, -2)                  # (B, HW, N)
    c = torch.sum(oc * oc, dim=-1)[:, None, :] - radii[..., None, :] ** 2
    disc = bq * bq - 4.0 * a[..., None] * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-bq - sq) / (2.0 * a[..., None])
    hit = (disc > 0.0) & (t > cam.near) & (t < cam.far)
    t = torch.amin(torch.where(hit, t, math.inf), dim=-1)
    return t.reshape(-1, cam.height, cam.width)


def render_rgbdm(cam: CameraParams, cam_pose_inv, points_world, albedo, valid=None,
                 occ_depth=None, occluder_color=None, light_gain=None, noise=None,
                 noise_std: float = 0.0):
    """RGBDM images (B, 5, H, W) of the target's surface points: RGB in
    [0, 1], metric depth, mask with 0 = target pixels, 1 = background
    (reference: env/panda_scene.py:433-437, 1163-1176).

    RGB is a proxy shading, the albedo (B, 3) over target pixels and the
    occluder colour elsewhere, scaled by 1 / (1 + 2 depth): the image's
    input contract, not photometric fidelity. `occ_depth` (B, H, W), +inf
    where clear, carries the scene's occluders: where one is nearer than
    the target by more than OCCLUSION_EPS, the pixel is background and
    shows the occluder's depth (reference: env/panda_scene.py:414-436).

    Domain randomisation (reference: env/panda_scene.py:599-618, 680-690):
    `occluder_color` (B, 3) replaces the occluder grey 0.5, `light_gain`
    (B,) scales the shading, and `noise` (B, 3, H, W) standard normal
    draws times `noise_std` are added to RGB before the clip. Depth and
    mask stay clean."""
    depth_t = render_depth_points(cam, cam_pose_inv, points_world, valid)
    occ = torch.full_like(depth_t, math.inf) if occ_depth is None else occ_depth
    t_hit = depth_t > 0
    t_vis = t_hit & (depth_t <= occ + OCCLUSION_EPS)
    scene = torch.minimum(torch.where(t_hit, depth_t, math.inf), occ)
    hit = torch.isfinite(scene)
    scene = torch.where(hit, scene, 0.0)
    shade = torch.where(hit, 1.0 / (1.0 + 2.0 * scene), 0.0)
    if light_gain is not None:
        shade = shade * light_gain[:, None, None]
    oc = (torch.full_like(albedo, 0.5) if occluder_color is None else occluder_color)
    color = torch.where(t_vis[:, None], albedo[:, :, None, None], oc[:, :, None, None])
    rgb = color * shade[:, None]
    if noise is not None:
        rgb = rgb + noise_std * noise
    rgb = torch.clamp(rgb, 0.0, 1.0)
    mask = torch.where(t_vis, 0.0, 1.0)
    return torch.cat([rgb, scene[:, None], mask[:, None]], dim=1)


def visible_target_depth(cam: CameraParams, cam_pose_inv, points_world, valid=None,
                         occ_depth=None):
    """Target depth images with occluded pixels zeroed: a target pixel
    survives unless an occluder is nearer by more than OCCLUSION_EPS
    (reference: core/utils.py:350,454-460)."""
    depth = render_depth_points(cam, cam_pose_inv, points_world, valid)
    if occ_depth is not None:
        depth = torch.where(depth <= occ_depth + OCCLUSION_EPS, depth, 0.0)
    return depth


def visible_points(cam: CameraParams, cam_pose_inv, points_world, valid=None,
                   max_points: int = 512, occ_depth=None):
    """Backprojected visible-surface samples in the camera frame: the
    occlusion-culled target depth images, their hit pixels' centres
    backprojected (reference: core/utils.py:454-472, without the OpenGL
    y-flip round trip). Returns (pts (B, max_points, 3), valid mask
    (B, max_points))."""
    depth = visible_target_depth(cam, cam_pose_inv, points_world, valid, occ_depth)
    return depth_to_points(cam, depth, max_points)


def depth_to_points(cam: CameraParams, depth, max_points: int = 512):
    """Backproject the nonzero pixels of depth images (B, H, W) to
    camera-frame points (B, max_points, 3) and a valid mask; hit pixel k
    lands in slot k by a prefix sum (no sort, no top-k)."""
    h, w = cam.height, cam.width
    b = depth.shape[0]
    depth = depth.reshape(b, h * w)
    hit = depth > 0
    slot = torch.cumsum(hit, dim=1) - 1
    slot = torch.where(hit & (slot < max_points), slot, max_points)  # spare slot
    pix = torch.arange(h * w, device=depth.device).expand(b, h * w)
    idx = torch.zeros((b, max_points + 1), dtype=torch.int64, device=depth.device)
    idx = idx.scatter(1, slot, pix)[:, :max_points]
    n_hit = hit.sum(dim=1, keepdim=True)
    picked = torch.arange(max_points, device=depth.device) < n_hit
    z = torch.gather(depth, 1, idx)
    u = (idx % w).to(torch.float32) + 0.5 - w / 2.0
    v = (idx // w).to(torch.float32) + 0.5 - h / 2.0
    f = cam.focal
    return torch.stack([u * z / f, v * z / f, z], dim=-1), picked
