"""Synthetic dataset generator (tests + benchmarks); the port's own copy
of ``f2nerf_tpu/data/synthetic.py``, pure numpy, the same generators and
draws, so one seed gives bitwise-equal scenes in both packages.

The reference has no test fixtures at all (SURVEY.md §4); this module
provides a procedurally rendered multi-view scene — a shaded colored
sphere over a grey background, ray-traced analytically in numpy — so unit
tests and benchmarks can train and evaluate end-to-end without external
data or network access.
"""

from __future__ import annotations

import numpy as np

from f2nerf_tpu_torch.data.dataset import Dataset


def look_at_pose(position: np.ndarray, target: np.ndarray,
                 up: np.ndarray | None = None) -> np.ndarray:
    """OpenGL-convention camera-to-world 3x4 (camera looks down -z)."""
    if up is None:
        up = np.array([0.0, 1.0, 0.0])
    z = position - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.zeros((3, 4), dtype=np.float32)
    pose[:, 0] = x
    pose[:, 1] = y
    pose[:, 2] = z
    pose[:, 3] = position
    return pose


def _camera_rays(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                 w: int) -> tuple[np.ndarray, np.ndarray]:
    """Pixel grid -> world-space unit ray dirs + origin, matching
    f2nerf_tpu.core.cameras.rays_from_pose exactly (half-pixel shift,
    OpenGL -z forward). Every procedural renderer and the depth-derived
    bounds (_depth_bounds) rely on this single definition."""
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    i = ii + 0.5
    j = jj + 0.5
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    u = (j - cx) / fx
    v = -((i - cy) / fy)
    d = np.stack([u, v, -np.ones_like(u)], axis=-1)
    d = d @ pose[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return pose[:3, 3], d


def _render_sphere(pose: np.ndarray, intrinsic: np.ndarray, h: int, w: int,
                   sphere_center: np.ndarray, sphere_radius: float,
                   color: np.ndarray, bg: float = 0.5,
                   return_depth: bool = False):
    """Analytic ray-traced shaded sphere, using the same ray convention
    as f2nerf_tpu.core.cameras.rays_from_pose."""
    o, d = _camera_rays(pose, intrinsic, h, w)

    oc = o - sphere_center
    b = np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc) - sphere_radius ** 2
    disc = b * b - c
    hit = disc > 0
    tt = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = hit & (tt > 0)

    p = o + d * tt[..., None]
    n = (p - sphere_center) / sphere_radius
    light = np.array([0.5, 0.7, 0.5])
    light = light / np.linalg.norm(light)
    shade = 0.35 + 0.65 * np.clip(n @ light, 0.0, 1.0)

    img = np.full((h, w, 3), bg, dtype=np.float32)
    img[hit] = (color[None, :] * shade[hit, None]).astype(np.float32)
    if return_depth:
        return img, np.where(hit, tt, np.inf)
    return img


def _render_scene(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                  w: int, bg: float = 0.55,
                  return_depth: bool = False):
    """Harder multi-object scene: checkerboard ground plane + shaded
    sphere + axis-aligned box, nearest-hit ray traced."""
    o, d = _camera_rays(pose, intrinsic, h, w)
    light = np.array([0.4, 0.8, 0.45])
    light /= np.linalg.norm(light)

    t_best = np.full((h, w), np.inf)
    # sky sphere (radius 3.6 around origin): every ray terminates on
    # consistent geometry, so a trained field can prune empty space
    # (a constant at-infinity background is view-inconsistent and
    # forces fog)
    oc0 = o
    b0 = np.sum(d * oc0, axis=-1)
    c0 = np.sum(oc0 * oc0) - 3.6 ** 2
    tsky = -b0 + np.sqrt(np.maximum(b0 * b0 - c0, 0))
    psky = o + d * tsky[..., None]
    sky = (bg + 0.18 * np.sin(2.1 * psky[..., 0])
           * np.cos(1.7 * psky[..., 2])
           + 0.1 * np.clip(psky[..., 1] / 3.6, -1, 1))
    color = np.stack([sky * 0.95, sky, np.minimum(sky * 1.1, 1.0)],
                     axis=-1).astype(np.float32)
    color = np.clip(color, 0.0, 1.0)

    # ground plane y = -0.8, checkerboard
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-0.8 - o[1]) / denom, np.inf)
    hitp = (tp > 0) & (tp < t_best)
    px = o[0] + d[..., 0] * tp
    pz = o[2] + d[..., 2] * tp
    checker = ((np.floor(px * 2) + np.floor(pz * 2)) % 2).astype(bool)
    pcol = np.where(checker[..., None], [0.85, 0.85, 0.8],
                    [0.25, 0.3, 0.35]).astype(np.float32)
    in_extent = (np.abs(px) < 2.5) & (np.abs(pz) < 2.5)
    hitp &= in_extent
    t_best = np.where(hitp, tp, t_best)
    color = np.where(hitp[..., None], pcol, color)

    # sphere at (0.5, -0.3, 0), r=0.5
    sc = np.array([0.5, -0.3, 0.0])
    oc = o - sc
    b = np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc) - 0.25
    disc = b * b - c
    ts = -b - np.sqrt(np.maximum(disc, 0))
    hits = (disc > 0) & (ts > 0) & (ts < t_best)
    n = (o + d * ts[..., None] - sc) / 0.5
    shade = 0.3 + 0.7 * np.clip(n @ light, 0, 1)
    scol = (np.array([0.85, 0.3, 0.25]) * shade[..., None]).astype(
        np.float32)
    t_best = np.where(hits, ts, t_best)
    color = np.where(hits[..., None], scol, color)

    # box [-0.9,-0.8,-0.5] .. [-0.3,-0.1,0.1] (slab method)
    lo = np.array([-0.9, -0.8, -0.5])
    hi = np.array([-0.3, -0.1, 0.1])
    safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
    t0 = (lo - o) / safe_d
    t1 = (hi - o) / safe_d
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hitb = (tmax > tmin) & (tmin > 0) & (tmin < t_best)
    pb = o + d * tmin[..., None]
    ctr = (lo + hi) / 2
    rel = (pb - ctr) / ((hi - lo) / 2)
    axis = np.argmax(np.abs(rel), axis=-1)
    nb = np.eye(3)[axis] * np.sign(
        np.take_along_axis(rel, axis[..., None], axis=-1))
    shade_b = 0.3 + 0.7 * np.clip(nb @ light, 0, 1)
    bcol = (np.array([0.25, 0.45, 0.8]) * shade_b[..., None]).astype(
        np.float32)
    color = np.where(hitb[..., None], bcol, color)
    if return_depth:
        t_best = np.where(hitb, tmin, t_best)
        return color, np.where(np.isfinite(t_best), t_best, tsky)
    return color


def _render_corridor(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                     w: int, length: float,
                     return_depth: bool = False):
    """Street/corridor scene for free-trajectory (F2-NeRF-style) tests:
    textured side walls, checker floor, obstacles along the way, far
    wall. Cameras travel *through* it, so scene content spans many
    units beyond the normalized camera cloud — the regime the
    perspective warp (models/warp.py) exists for, unlike the orbiting
    checker scene where contraction suffices."""
    o, d = _camera_rays(pose, intrinsic, h, w)
    light = np.array([0.3, 0.85, -0.4])
    light /= np.linalg.norm(light)

    t_best = np.full((h, w), np.inf)
    # sky fallback by ray direction (rays escaping the open ceiling)
    sky_t = np.clip(d[..., 1], 0.0, 1.0)
    color = np.stack([0.55 + 0.25 * sky_t, 0.65 + 0.2 * sky_t,
                      0.8 + 0.15 * sky_t], axis=-1).astype(np.float32)

    zlo, zhi = -2.0, length + 4.0

    def plane_hit(axis, value, lo_a, hi_a, lo_b, hi_b):
        """Axis-aligned plane with rectangular extent; returns (t, mask,
        hit point). The two extent axes are the other two dims."""
        denom = d[..., axis]
        t = np.where(np.abs(denom) > 1e-6,
                     (value - o[axis]) / denom, np.inf)
        p = o[None, None, :] + d * t[..., None]
        oth = [a for a in range(3) if a != axis]
        ok = ((t > 1e-3) & (t < t_best)
              & (p[..., oth[0]] >= lo_a) & (p[..., oth[0]] <= hi_a)
              & (p[..., oth[1]] >= lo_b) & (p[..., oth[1]] <= hi_b))
        return t, ok, p

    # floor y=-1, checker
    t, ok, p = plane_hit(1, -1.0, -2.0, 2.0, zlo, zhi)
    checker = ((np.floor(p[..., 0] * 1.5)
                + np.floor(p[..., 2] * 1.5)) % 2).astype(bool)
    col = np.where(checker[..., None], [0.8, 0.78, 0.72],
                   [0.3, 0.32, 0.38]).astype(np.float32)
    t_best = np.where(ok, t, t_best)
    color = np.where(ok[..., None], col, color)

    # side walls x = +-2, banded texture in (y, z)
    for side, base in ((-2.0, np.array([0.75, 0.45, 0.35])),
                       (2.0, np.array([0.4, 0.55, 0.75]))):
        t, ok, p = plane_hit(0, side, -1.0, 2.0, zlo, zhi)
        tex = (0.55 + 0.3 * np.sin(2.4 * p[..., 2])
               * np.cos(3.1 * p[..., 1])
               + 0.15 * (np.floor(p[..., 2] * 2) % 2))
        col = (base[None, None, :] * tex[..., None]).astype(np.float32)
        t_best = np.where(ok, t, t_best)
        color = np.where(ok[..., None], np.clip(col, 0, 1), color)

    # far wall z = zhi
    t, ok, p = plane_hit(2, zhi, -2.0, 2.0, -1.0, 2.0)
    tex = 0.45 + 0.25 * np.sin(3.0 * p[..., 0]) * np.sin(2.2 * p[..., 1])
    col = np.stack([tex, tex * 0.9, tex * 0.8], axis=-1).astype(np.float32)
    t_best = np.where(ok, t, t_best)
    color = np.where(ok[..., None], col, color)

    # obstacles along the corridor: boxes + spheres, alternating sides
    k = 0
    z = 2.5
    while z < length + 1.0:
        side = -1.0 if k % 2 == 0 else 1.0
        if k % 2 == 0:  # box on the floor
            lo = np.array([side * 1.1 - 0.35, -1.0, z - 0.35])
            hi = np.array([side * 1.1 + 0.35, -0.25, z + 0.35])
            safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
            t0 = (lo - o) / safe_d
            t1 = (hi - o) / safe_d
            tmin = np.max(np.minimum(t0, t1), axis=-1)
            tmax = np.min(np.maximum(t0, t1), axis=-1)
            ok = (tmax > tmin) & (tmin > 1e-3) & (tmin < t_best)
            p = o + d * tmin[..., None]
            ctr = (lo + hi) / 2
            rel = (p - ctr) / ((hi - lo) / 2)
            axis = np.argmax(np.abs(rel), axis=-1)
            nrm = np.eye(3)[axis] * np.sign(
                np.take_along_axis(rel, axis[..., None], axis=-1))
            shade = 0.3 + 0.7 * np.clip(nrm @ light, 0, 1)
            base = np.array([0.8, 0.6, 0.2]) if k % 4 == 0 \
                else np.array([0.3, 0.7, 0.45])
            col = (base * shade[..., None]).astype(np.float32)
            t_best = np.where(ok, tmin, t_best)
            color = np.where(ok[..., None], col, color)
        else:  # floating sphere
            sc = np.array([side * 1.0, -0.35, z])
            oc = o - sc
            b = np.sum(d * oc, axis=-1)
            c2 = np.sum(oc * oc) - 0.3 ** 2
            disc = b * b - c2
            ts = -b - np.sqrt(np.maximum(disc, 0))
            ok = (disc > 0) & (ts > 1e-3) & (ts < t_best)
            n = (o + d * ts[..., None] - sc) / 0.3
            shade = 0.3 + 0.7 * np.clip(n @ light, 0, 1)
            base = np.array([0.75, 0.3, 0.5]) if k % 4 == 1 \
                else np.array([0.25, 0.4, 0.8])
            col = (base * shade[..., None]).astype(np.float32)
            t_best = np.where(ok, ts, t_best)
            color = np.where(ok[..., None], col, color)
        k += 1
        z += 2.0
    if return_depth:
        return np.clip(color, 0.0, 1.0), t_best
    return np.clip(color, 0.0, 1.0)


def make_corridor_dataset(n_images: int = 24, h: int = 128, w: int = 128,
                          length: float = 16.0,
                          seed: int = 0) -> Dataset:
    """Free forward trajectory through a corridor (BASELINE configs[2,3]
    regime: long non-orbiting path, unbounded-ish content). Cameras
    sway laterally and look ahead along the path."""
    rng = np.random.default_rng(seed)
    focal = 0.75 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)

    def path(z):
        return np.array([0.6 * np.sin(2.4 * np.pi * z / length),
                         0.25 + 0.1 * np.sin(1.3 * z), z])

    poses, images, depths = [], [], []
    for kimg in range(n_images):
        z = 0.5 + (length - 2.0) * kimg / max(n_images - 1, 1)
        pos = path(z) + rng.normal(0, 0.02, 3)
        target = path(z + 2.5)
        target[2] = z + 2.5
        pose = look_at_pose(pos, target)
        poses.append(pose)
        img, dep = _render_corridor(pose, intrinsic, h, w, length,
                                    return_depth=True)
        images.append(img)
        depths.append(dep)
    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)
    return Dataset(
        poses=poses, intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images), center=center, radius=radius)


def make_checker_dataset(n_images: int = 12, h: int = 96, w: int = 96,
                         ring_radius: float = 3.0,
                         seed: int = 0) -> Dataset:
    """Multi-object scene (checker ground + sphere + box): harder than
    the single sphere, exercises occupancy pruning and view-dependent
    shading more meaningfully."""
    rng = np.random.default_rng(seed)
    focal = 0.9 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)
    poses, images, depths = [], [], []
    for k in range(n_images):
        ang = 2.0 * np.pi * k / n_images
        elev = 0.5 + 0.12 * rng.standard_normal()
        pos = ring_radius * np.array([
            np.cos(ang) * np.cos(elev), np.sin(elev),
            np.sin(ang) * np.cos(elev)])
        pose = look_at_pose(pos, np.array([0.0, -0.3, 0.0]))
        poses.append(pose)
        img, dep = _render_scene(pose, intrinsic, h, w,
                                 return_depth=True)
        images.append(img)
        depths.append(dep)
    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)
    return Dataset(
        poses=poses, intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images), center=center, radius=radius)


def make_sphere_dataset(n_images: int = 8, h: int = 64, w: int = 64,
                        ring_radius: float = 3.0,
                        seed: int = 0) -> Dataset:
    """Cameras on a ring looking at a unit sphere at the origin."""
    rng = np.random.default_rng(seed)
    focal = 0.8 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)
    color = np.array([0.8, 0.35, 0.25], dtype=np.float32)

    poses, images, depths = [], [], []
    for k in range(n_images):
        ang = 2.0 * np.pi * k / n_images
        elev = 0.35 + 0.1 * rng.standard_normal()
        pos = ring_radius * np.array([
            np.cos(ang) * np.cos(elev), np.sin(elev),
            np.sin(ang) * np.cos(elev)])
        pose = look_at_pose(pos, np.zeros(3))
        poses.append(pose)
        img, dep = _render_sphere(pose, intrinsic, h, w,
                                  np.zeros(3), 1.0, color,
                                  return_depth=True)
        images.append(img)
        depths.append(dep)

    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)

    return Dataset(
        poses=poses,
        intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images),
        center=center, radius=radius)


def _depth_bounds(depths: list[np.ndarray]) -> np.ndarray:
    """Per-camera [near, far] from traced hit depths — the same policy
    as scripts/colmap2poses.py's SfM depth-percentile bounds (2nd pct *
    0.8 / max * 1.2), so ModelConfig.sample_near = -1 (auto) lands the
    march start at the closest real scene content for synthetic
    datasets exactly like it does for COLMAP ones."""
    out = []
    for dmap in depths:
        fin = dmap[np.isfinite(dmap)]
        if fin.size == 0:
            out.append([0.1, 10.0])
            continue
        out.append([0.8 * float(np.percentile(fin, 2.0)),
                    1.2 * float(fin.max())])
    return np.asarray(out, dtype=np.float32)


# ---------------------------------------------------------------------------
# Aperiodic textured scene (round-4 eval gate)
# ---------------------------------------------------------------------------

_NOISE_RNG = np.random.default_rng(171)
_NOISE_GRIDS = [_NOISE_RNG.random((48, 48)).astype(np.float32)
                for _ in range(4)]


def _value_noise(u: np.ndarray, v: np.ndarray, grid_id: int,
                 octaves: int = 3) -> np.ndarray:
    """Aperiodic multi-octave value noise over [0,1]^2: each octave
    bilinearly samples a FIXED random grid at an irrational frequency
    ratio, so no translate of the pattern repeats within the surface
    extent.

    NOTE (ADVICE r4, intentional): octaves with f > 1 apply
    ``u * f % 1.0`` BEFORE the clip, so the wrap introduces hard value
    steps at u = k/f inside the surface extent. These seams are kept
    deliberately: they are extra aperiodic high-frequency texture (the
    scene is a generalization gate, not a smoothness benchmark), and
    changing the function would change the gt images out from under
    every trained checkpoint that uses this scene."""
    total = np.zeros_like(u)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        g = _NOISE_GRIDS[(grid_id + o) % len(_NOISE_GRIDS)]
        n = g.shape[0] - 1
        f = (1.0 + o * 2.718281828)      # irrational octave ratios
        x = np.clip(u * f % 1.0, 0.0, 1.0) * n
        y = np.clip(v * f % 1.0, 0.0, 1.0) * n
        x0 = np.clip(x.astype(np.int32), 0, n - 1)
        y0 = np.clip(y.astype(np.int32), 0, n - 1)
        fx = x - x0
        fy = y - y0
        fx = fx * fx * (3 - 2 * fx)      # smoothstep
        fy = fy * fy * (3 - 2 * fy)
        v00 = g[x0, y0]
        v10 = g[x0 + 1, y0]
        v01 = g[x0, y0 + 1]
        v11 = g[x0 + 1, y0 + 1]
        total += amp * ((v00 * (1 - fx) + v10 * fx) * (1 - fy)
                        + (v01 * (1 - fx) + v11 * fx) * fy)
        norm += amp
        amp *= 0.55
    return total / norm


def _render_textured(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                     w: int, return_depth: bool = False):
    """Aperiodic variant of :func:`_render_scene`: same geometry family
    (ground plane + sphere + box + sky sphere) but every surface carries
    value-noise + linear-ramp texture with NO repeating pattern — the
    round-3 holdout autopsy implicated the checker floor's period
    ambiguity (wrong depths stay photo-consistent on a periodic
    texture); this scene is the aperiodic eval gate (VERDICT r3
    missing #2)."""
    o, d = _camera_rays(pose, intrinsic, h, w)
    light = np.array([0.4, 0.8, 0.45])
    light /= np.linalg.norm(light)

    t_best = np.full((h, w), np.inf)

    # sky sphere (radius 3.6): aperiodic noise + vertical ramp
    b0 = np.sum(d * o, axis=-1)
    c0 = np.sum(o * o) - 3.6 ** 2
    tsky = -b0 + np.sqrt(np.maximum(b0 * b0 - c0, 0))
    psky = o + d * tsky[..., None]
    su = (psky[..., 0] / 7.2) + 0.5
    sv = (psky[..., 2] / 7.2) + 0.5
    nz = _value_noise(su, sv, 0)
    sky = 0.5 + 0.25 * (nz - 0.5) + 0.15 * np.clip(psky[..., 1] / 3.6,
                                                   -1, 1)
    color = np.stack([sky * 0.9, sky * 0.97, np.minimum(sky * 1.08, 1.0)],
                     axis=-1).astype(np.float32)
    color = np.clip(color, 0.0, 1.0)

    # ground plane y = -0.8: value noise + x/z color ramps (the ramps
    # make every floor patch globally unique — no period ambiguity)
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-0.8 - o[1]) / denom, np.inf)
    hitp = (tp > 0) & (tp < t_best)
    px = o[0] + d[..., 0] * tp
    pz = o[2] + d[..., 2] * tp
    gu = np.clip(px / 5.0 + 0.5, 0.0, 1.0)
    gv = np.clip(pz / 5.0 + 0.5, 0.0, 1.0)
    n1 = _value_noise(gu, gv, 1)
    n2 = _value_noise(gu, gv, 2)
    pcol = np.stack([0.25 + 0.55 * n1 + 0.15 * gu,
                     0.25 + 0.45 * n2 + 0.15 * gv,
                     0.30 + 0.40 * (1.0 - n1)], axis=-1)
    pcol = np.clip(pcol, 0.0, 1.0).astype(np.float32)
    in_extent = (np.abs(px) < 2.5) & (np.abs(pz) < 2.5)
    hitp &= in_extent
    t_best = np.where(hitp, tp, t_best)
    color = np.where(hitp[..., None], pcol, color)

    # sphere at (0.5, -0.3, 0), r=0.5: noise-marbled + shaded
    sc = np.array([0.5, -0.3, 0.0])
    oc = o - sc
    b = np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc) - 0.25
    disc = b * b - c
    ts = -b - np.sqrt(np.maximum(disc, 0))
    hits = (disc > 0) & (ts > 0) & (ts < t_best)
    n = (o + d * ts[..., None] - sc) / 0.5
    shade = 0.3 + 0.7 * np.clip(n @ light, 0, 1)
    mu = np.clip(np.arctan2(n[..., 2], n[..., 0]) / (2 * np.pi) + 0.5,
                 0, 1)
    mv = np.clip(n[..., 1] * 0.5 + 0.5, 0, 1)
    marble = _value_noise(mu, mv, 3)
    scol = np.stack([0.55 + 0.35 * marble, 0.25 + 0.25 * (1 - marble),
                     0.2 + 0.2 * marble], axis=-1) * shade[..., None]
    scol = np.clip(scol, 0, 1).astype(np.float32)
    t_best = np.where(hits, ts, t_best)
    color = np.where(hits[..., None], scol, color)

    # box [-0.9,-0.8,-0.5]..[-0.3,-0.1,0.1]: per-face ramped texture
    lo = np.array([-0.9, -0.8, -0.5])
    hi = np.array([-0.3, -0.1, 0.1])
    safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
    t0 = (lo - o) / safe_d
    t1 = (hi - o) / safe_d
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hitb = (tmax > tmin) & (tmin > 0) & (tmin < t_best)
    pb = o + d * tmin[..., None]
    ctr = (lo + hi) / 2
    rel = (pb - ctr) / ((hi - lo) / 2)
    axis = np.argmax(np.abs(rel), axis=-1)
    nb = np.eye(3)[axis] * np.sign(
        np.take_along_axis(rel, axis[..., None], axis=-1))
    shade_b = 0.3 + 0.7 * np.clip(nb @ light, 0, 1)
    bu = np.clip((pb[..., 0] - lo[0]) / (hi[0] - lo[0]), 0, 1)
    bv = np.clip((pb[..., 1] - lo[1]) / (hi[1] - lo[1]), 0, 1)
    bn = _value_noise(bu, bv, 2)
    bcol = np.stack([0.2 + 0.3 * bn, 0.35 + 0.3 * bu,
                     0.55 + 0.35 * (1 - bn)], axis=-1) \
        * shade_b[..., None]
    color = np.where(hitb[..., None],
                     np.clip(bcol, 0, 1).astype(np.float32), color)
    if return_depth:
        t_best = np.where(hitb, tmin, t_best)
        return color, np.where(np.isfinite(t_best), t_best, tsky)
    return color


def _longtraj_path(z: np.ndarray | float) -> np.ndarray:
    """Winding camera path for the long-trajectory scene: two
    incommensurate lateral sinusoids (period ratio irrational) so the
    path never repeats a bend over the full length — the BASELINE
    configs[3] "long free camera trajectory" regime."""
    z = np.asarray(z, dtype=np.float64)
    x = 1.5 * np.sin(2 * np.pi * z / 13.7) \
        + 0.9 * np.sin(2 * np.pi * z / 5.3 + 1.0)
    y = 0.25 + 0.1 * np.sin(z / 3.1)
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def _longtraj_obstacles(length: float, seed: int) -> list[dict]:
    """Deterministic obstacle layout along the winding path: alternating
    textured boxes and spheres offset laterally from the path so the
    cameras never collide."""
    rng = np.random.default_rng(seed + 29)
    objs = []
    z = 2.0
    k = 0
    while z < length + 2.0:
        side = -1.0 if k % 2 == 0 else 1.0
        px = float(_longtraj_path(z)[0])
        lat = side * (1.2 + 0.6 * rng.random())
        size = 0.25 + 0.25 * rng.random()
        base = np.array([0.25 + 0.6 * rng.random(),
                         0.25 + 0.6 * rng.random(),
                         0.25 + 0.6 * rng.random()], dtype=np.float64)
        kind = "box" if k % 2 == 0 else "sphere"
        # both shapes rest on the floor: extent is center +- size
        objs.append({"kind": kind, "grid": k % 4, "base": base,
                     "center": np.array([px + lat, -1.0 + size, z]),
                     "size": size})
        k += 1
        z += 1.4 + 0.8 * rng.random()
    return objs


def _render_longtraj(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                     w: int, length: float, objs: list[dict],
                     return_depth: bool = False):
    """Long winding-trajectory scene (BASELINE configs[3]): aperiodic
    value-noise ground with global color ramps (no period ambiguity),
    dozens of noise-textured obstacles along the path, aperiodic sky
    dome. Scene content spans many units beyond the normalized camera
    cloud — the regime the perspective warp (models/warp.py) exists
    for; also the localization stress scene."""
    o, d = _camera_rays(pose, intrinsic, h, w)
    light = np.array([0.35, 0.82, -0.45])
    light /= np.linalg.norm(light)
    t_best = np.full((h, w), np.inf)

    # sky dome: big sphere centered mid-path, aperiodic noise + ramp
    sky_c = np.array([0.0, 0.0, length / 2.0])
    sky_r = 0.9 * length
    oc = o - sky_c
    b0 = np.sum(d * oc, axis=-1)
    c0 = np.sum(oc * oc) - sky_r ** 2
    tsky = -b0 + np.sqrt(np.maximum(b0 * b0 - c0, 0))
    psky = (o + d * tsky[..., None] - sky_c) / sky_r
    su = np.clip(np.arctan2(psky[..., 2], psky[..., 0])
                 / (2 * np.pi) + 0.5, 0, 1)
    sv = np.clip(psky[..., 1] * 0.5 + 0.5, 0, 1)
    nz = _value_noise(su, sv, 0)
    sky = 0.5 + 0.22 * (nz - 0.5) + 0.18 * np.clip(psky[..., 1], -1, 1)
    color = np.stack([sky * 0.88, sky * 0.96,
                      np.minimum(sky * 1.1, 1.0)],
                     axis=-1).astype(np.float32)
    color = np.clip(color, 0.0, 1.0)

    # ground plane y = -1: aperiodic noise + global x/z ramps
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-1.0 - o[1]) / denom, np.inf)
    hitp = (tp > 1e-3) & (tp < t_best)
    px = o[0] + d[..., 0] * tp
    pz = o[2] + d[..., 2] * tp
    gu = np.clip(px / 16.0 + 0.5, 0.0, 1.0)
    gv = np.clip(pz / (length + 12.0) + 0.1, 0.0, 1.0)
    n1 = _value_noise(gu, gv, 1, octaves=4)
    n2 = _value_noise(gu, gv, 2, octaves=4)
    pcol = np.stack([0.22 + 0.5 * n1 + 0.2 * gu,
                     0.25 + 0.45 * n2 + 0.2 * gv,
                     0.3 + 0.4 * (1.0 - n1)], axis=-1)
    pcol = np.clip(pcol, 0.0, 1.0).astype(np.float32)
    in_extent = (np.abs(px) < 8.0) & (pz > -6.0) & (pz < length + 10.0)
    hitp &= in_extent
    t_best = np.where(hitp, tp, t_best)
    color = np.where(hitp[..., None], pcol, color)

    safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
    for ob in objs:
        ctr, size = ob["center"], ob["size"]
        if ob["kind"] == "sphere":
            oc = o - ctr
            b = np.sum(d * oc, axis=-1)
            c2 = np.sum(oc * oc) - size ** 2
            disc = b * b - c2
            ts = -b - np.sqrt(np.maximum(disc, 0))
            ok = (disc > 0) & (ts > 1e-3) & (ts < t_best)
            n = (o + d * ts[..., None] - ctr) / size
            shade = 0.3 + 0.7 * np.clip(n @ light, 0, 1)
            mu = np.clip(np.arctan2(n[..., 2], n[..., 0])
                         / (2 * np.pi) + 0.5, 0, 1)
            mv = np.clip(n[..., 1] * 0.5 + 0.5, 0, 1)
            tex = _value_noise(mu, mv, ob["grid"])
            col = (ob["base"][None, None, :]
                   * (0.55 + 0.65 * tex[..., None])
                   * shade[..., None])
            t_best = np.where(ok, ts, t_best)
            color = np.where(ok[..., None],
                             np.clip(col, 0, 1).astype(np.float32),
                             color)
        else:
            lo = ctr - size
            hi = ctr + size
            t0 = (lo - o) / safe_d
            t1 = (hi - o) / safe_d
            tmin = np.max(np.minimum(t0, t1), axis=-1)
            tmax = np.min(np.maximum(t0, t1), axis=-1)
            ok = (tmax > tmin) & (tmin > 1e-3) & (tmin < t_best)
            pb = o + d * tmin[..., None]
            rel = (pb - ctr) / size
            axis = np.argmax(np.abs(rel), axis=-1)
            nb = np.eye(3)[axis] * np.sign(
                np.take_along_axis(rel, axis[..., None], axis=-1))
            shade = 0.3 + 0.7 * np.clip(nb @ light, 0, 1)
            bu = np.clip((pb[..., 0] - lo[0]) / (2 * size), 0, 1)
            bv = np.clip((pb[..., 1] - lo[1]) / (2 * size), 0, 1)
            tex = _value_noise(bu, bv, ob["grid"])
            col = (ob["base"][None, None, :]
                   * (0.5 + 0.5 * tex[..., None] + 0.25 * bu[..., None])
                   * shade[..., None])
            t_best = np.where(ok, tmin, t_best)
            color = np.where(ok[..., None],
                             np.clip(col, 0, 1).astype(np.float32),
                             color)
    if return_depth:
        return color, np.where(np.isfinite(t_best), t_best, tsky)
    return color


def make_longtraj_dataset(n_images: int = 64, h: int = 128, w: int = 128,
                          length: float = 40.0,
                          seed: int = 0) -> Dataset:
    """Long free-trajectory stress scene (VERDICT r4 #3 / BASELINE
    configs[3]): >= 64 cameras along an aperiodically winding path
    through obstacle fields with aperiodic textures. The per-view
    depth range runs from ~1 unit (nearest obstacle) to the sky dome,
    stressing warp-space adaptivity and the occupancy sampler; holdout
    poses interpolate the path, so novel-view quality and localization
    are both meaningful gates here."""
    rng = np.random.default_rng(seed)
    focal = 0.75 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)
    objs = _longtraj_obstacles(length, seed)
    poses, images, depths = [], [], []
    for kimg in range(n_images):
        z = 0.5 + (length - 2.0) * kimg / max(n_images - 1, 1)
        pos = _longtraj_path(z)[()] + rng.normal(0, 0.02, 3)
        target = _longtraj_path(z + 2.5)[()]
        pose = look_at_pose(pos, target)
        poses.append(pose)
        img, dep = _render_longtraj(pose, intrinsic, h, w, length, objs,
                                    return_depth=True)
        images.append(img)
        depths.append(dep)
    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)
    return Dataset(
        poses=poses, intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images), center=center, radius=radius)


def make_textured_dataset(n_images: int = 32, h: int = 128, w: int = 128,
                          ring_radius: float = 3.0,
                          seed: int = 0) -> Dataset:
    """Aperiodic-texture ring scene: same cameras as
    :func:`make_checker_dataset`, textured surfaces with no repeating
    pattern (the round-4 generalization gate)."""
    rng = np.random.default_rng(seed)
    focal = 0.9 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)
    poses, images, depths = [], [], []
    for k in range(n_images):
        ang = 2.0 * np.pi * k / n_images
        elev = 0.5 + 0.12 * rng.standard_normal()
        pos = ring_radius * np.array([
            np.cos(ang) * np.cos(elev), np.sin(elev),
            np.sin(ang) * np.cos(elev)])
        pose = look_at_pose(pos, np.array([0.0, -0.3, 0.0]))
        poses.append(pose)
        img, dep = _render_textured(pose, intrinsic, h, w,
                                    return_depth=True)
        images.append(img)
        depths.append(dep)
    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)
    return Dataset(
        poses=poses, intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images), center=center, radius=radius)


# ---------------------------------------------------------------------------
# Inward-facing 360-degree object capture (round-5: the ngp_fox-shaped
# proxy VERDICT r4 "missing #1" names — BASELINE configs[0] is an
# inward object capture; reference data contract src/dataset.cpp:40-104)
# ---------------------------------------------------------------------------


def _render_objcap(pose: np.ndarray, intrinsic: np.ndarray, h: int,
                   w: int, return_depth: bool = False):
    """Analytic render of a compound object (box body + sphere head +
    ears + tail) on a small ground disk under a noise sky — a fox-shaped
    stand-in for the inward 360-degree captures the reference targets
    (ngp_fox, BASELINE configs[0]). Every surface carries aperiodic
    value-noise texture (no period ambiguity, same rationale as
    :func:`_render_textured`); the object self-occludes across views,
    which is the capture regime's distinctive stress."""
    o, d = _camera_rays(pose, intrinsic, h, w)
    light = np.array([0.45, 0.8, 0.35])
    light /= np.linalg.norm(light)

    t_best = np.full((h, w), np.inf)

    # sky dome (radius 6): aperiodic noise + vertical ramp
    b0 = np.sum(d * o, axis=-1)
    c0 = np.sum(o * o) - 6.0 ** 2
    tsky = -b0 + np.sqrt(np.maximum(b0 * b0 - c0, 0))
    psky = o + d * tsky[..., None]
    su = (psky[..., 0] / 12.0) + 0.5
    sv = (psky[..., 2] / 12.0) + 0.5
    nz = _value_noise(su, sv, 0)
    sky = 0.55 + 0.2 * (nz - 0.5) + 0.12 * np.clip(psky[..., 1] / 6.0,
                                                   -1, 1)
    color = np.stack([sky * 0.92, sky * 0.96, np.minimum(sky * 1.06, 1.0)],
                     axis=-1).astype(np.float32)
    color = np.clip(color, 0.0, 1.0)

    # ground disk y = -0.45, radius 1.4: noise + radial ramp
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-0.45 - o[1]) / denom, np.inf)
    px = o[0] + d[..., 0] * tp
    pz = o[2] + d[..., 2] * tp
    rad = np.sqrt(px * px + pz * pz)
    hitp = (tp > 0) & (tp < t_best) & (rad < 1.4)
    gu = np.clip(px / 2.8 + 0.5, 0.0, 1.0)
    gv = np.clip(pz / 2.8 + 0.5, 0.0, 1.0)
    n1 = _value_noise(gu, gv, 1)
    pcol = np.stack([0.30 + 0.40 * n1 + 0.10 * gu,
                     0.28 + 0.35 * (1 - n1) + 0.10 * gv,
                     0.22 + 0.30 * n1], axis=-1)
    pcol = np.clip(pcol, 0.0, 1.0).astype(np.float32)
    t_best = np.where(hitp, tp, t_best)
    color = np.where(hitp[..., None], pcol, color)

    # body box [-0.35,-0.45,-0.22]..[0.35,0.05,0.22]: noise texture
    lo = np.array([-0.35, -0.45, -0.22])
    hi = np.array([0.35, 0.05, 0.22])
    safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
    t0 = (lo - o) / safe_d
    t1 = (hi - o) / safe_d
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hitb = (tmax > tmin) & (tmin > 0) & (tmin < t_best)
    pb = o + d * tmin[..., None]
    ctr = (lo + hi) / 2
    rel = (pb - ctr) / ((hi - lo) / 2)
    axis = np.argmax(np.abs(rel), axis=-1)
    nb = np.eye(3)[axis] * np.sign(
        np.take_along_axis(rel, axis[..., None], axis=-1))
    shade_b = 0.35 + 0.65 * np.clip(nb @ light, 0, 1)
    bu = np.clip((pb[..., 0] - lo[0]) / (hi[0] - lo[0]), 0, 1)
    bv = np.clip((pb[..., 2] - lo[2]) / (hi[2] - lo[2]), 0, 1)
    bn = _value_noise(bu, bv, 2)
    bcol = np.stack([0.60 + 0.30 * bn, 0.32 + 0.25 * bu,
                     0.12 + 0.18 * (1 - bn)], axis=-1) \
        * shade_b[..., None]
    t_best = np.where(hitb, tmin, t_best)
    color = np.where(hitb[..., None],
                     np.clip(bcol, 0, 1).astype(np.float32), color)

    # head + ears + tail: noise-marbled shaded spheres
    spheres = (
        (np.array([0.46, 0.24, 0.0]), 0.26, 3, (0.65, 0.33, 0.14)),
        (np.array([0.54, 0.52, 0.13]), 0.09, 1, (0.55, 0.28, 0.12)),
        (np.array([0.54, 0.52, -0.13]), 0.09, 1, (0.55, 0.28, 0.12)),
        (np.array([-0.52, -0.12, 0.0]), 0.17, 2, (0.78, 0.62, 0.45)),
    )
    for sc, sr, gid, base in spheres:
        oc = o - sc
        b = np.sum(d * oc, axis=-1)
        c = np.sum(oc * oc) - sr * sr
        disc = b * b - c
        ts = -b - np.sqrt(np.maximum(disc, 0))
        hits = (disc > 0) & (ts > 0) & (ts < t_best)
        n = (o + d * ts[..., None] - sc) / sr
        shade = 0.35 + 0.65 * np.clip(n @ light, 0, 1)
        mu = np.clip(np.arctan2(n[..., 2], n[..., 0]) / (2 * np.pi)
                     + 0.5, 0, 1)
        mv = np.clip(n[..., 1] * 0.5 + 0.5, 0, 1)
        marble = _value_noise(mu, mv, gid)
        scol = np.stack([base[0] + 0.25 * marble,
                         base[1] + 0.20 * (1 - marble),
                         base[2] + 0.15 * marble], axis=-1) \
            * shade[..., None]
        scol = np.clip(scol, 0, 1).astype(np.float32)
        t_best = np.where(hits, ts, t_best)
        color = np.where(hits[..., None], scol, color)

    if return_depth:
        return color, np.where(np.isfinite(t_best), t_best, tsky)
    return color


def make_objcap_dataset(n_images: int = 48, h: int = 128, w: int = 128,
                        cam_radius: float = 1.9,
                        seed: int = 0) -> Dataset:
    """Inward-facing 360-degree object capture: cameras on a golden-
    angle spiral over a spherical cap (full azimuth, elevations
    ~12-58 degrees), all aimed at the object — the ngp_fox-style
    capture shape (BASELINE configs[0]; the last unbuilt proxy from
    VERDICT r4 "missing #1"). Depth-percentile bounds are written the
    same way colmap2poses does, so auto-near lands at the closest
    object/ground content."""
    rng = np.random.default_rng(seed)
    focal = 1.1 * w
    intrinsic = np.array([[focal, 0, w / 2.0],
                          [0, focal, h / 2.0],
                          [0, 0, 1.0]], dtype=np.float32)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    target = np.array([0.0, -0.05, 0.0])
    poses, images, depths = [], [], []
    for k in range(n_images):
        az = golden * k
        elev = np.deg2rad(12.0 + 46.0 * ((k + 0.5) / n_images)) \
            + rng.normal(0, 0.01)
        pos = cam_radius * np.array([
            np.cos(az) * np.cos(elev), np.sin(elev),
            np.sin(az) * np.cos(elev)]) + rng.normal(0, 0.01, 3)
        pose = look_at_pose(pos, target)
        poses.append(pose)
        img, dep = _render_objcap(pose, intrinsic, h, w,
                                  return_depth=True)
        images.append(img)
        depths.append(dep)
    poses = np.stack(poses).astype(np.float32)
    from f2nerf_tpu_torch.core.cameras import normalize_poses
    poses, center, radius = normalize_poses(poses)
    return Dataset(
        poses=poses, intrinsics=np.stack([intrinsic] * n_images),
        dist_params=np.zeros((n_images, 4), dtype=np.float32),
        bounds=_depth_bounds(depths),
        images=np.stack(images), center=center, radius=radius)
