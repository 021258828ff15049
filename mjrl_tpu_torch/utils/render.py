"""Offscreen trajectory rendering (counterpart of
``mjrl_tpu/utils/render.py``).

Two halves:

- **Geometry, on the device.**  ``trajectory_geometry`` runs one batched
  forward-kinematics call (``physics/kinematics.py``) over all frames of a
  trajectory, the frames as the batch axis, on the env's device, and moves
  every geom's world position and orientation to the host once.
- **Drawing, on the host.**  Every geom is a shaded triangle mesh
  (Lambertian lighting, painter-sorted faces, a checkerboard ground plane)
  drawn with matplotlib's 3D axes, the same polygons in the same colours as
  the JAX package; the frames go to mp4 (OpenCV), an animated GIF (PIL) or
  per-frame PNGs.

matplotlib, PIL and OpenCV are imported where they are used.  Without
matplotlib nothing is drawn: ``render_trajectory`` says so and returns 0.
``visualize_policy`` steps the env itself (``env.step``: on a planar model
on the GPU one launch of the planar kernel per control step, at B = 1) and
writes each episode's qpos sequence beside its video
(``episode_<i>_qpos.npy``), so a machine without the drawing packages
still leaves what to draw (``visualize_trajectories --file``).
"""

import os

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator, resolve_device
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.model import BOX, CAPSULE, CYLINDER, PLANE, SPHERE

_LIGHT = np.array([0.35, -0.4, 0.85])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_PALETTE = [(0.26, 0.45, 0.76), (0.88, 0.52, 0.21), (0.34, 0.64, 0.37),
            (0.75, 0.31, 0.32), (0.58, 0.47, 0.71), (0.55, 0.57, 0.67)]


def drawing_available():
    """-> (True, None), or (False, the reason) when matplotlib is
    missing."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        return False, f"matplotlib is not installed ({exc})"
    return True, None


# -- geometry, on the device --------------------------------------------------

@torch.no_grad()
def trajectory_geometry(model, qpos_seq, device=None, dtype=torch.float32,
                        body_pos=None):
    """World positions (T, ngeom, 3) and orientations (T, ngeom, 3, 3) of
    every geom at each configuration of ``qpos_seq`` (T, nq), as numpy
    arrays: one forward-kinematics call with the frames as the batch axis
    on ``device`` (default: the GPU), one copy to the host.  ``body_pos``
    (nbody, 3) or (1, nbody, 3): body offsets moved by an env's scenery."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(qpos_seq), dtype=dtype, device=dev)
    if body_pos is not None:
        body_pos = torch.as_tensor(body_pos, dtype=dtype, device=dev)
        body_pos = body_pos.reshape(1, model.nbody, 3).expand(
            q.shape[0], -1, -1)
    data = fwd_kinematics(model, q, body_pos=body_pos)
    return data.geom_xpos.cpu().numpy(), data.geom_xmat.cpu().numpy()


# -- meshes, on the host --------------------------------------------------------

def _uv_sphere(r, n=10):
    u = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    v = np.linspace(0, np.pi, n)
    uu, vv = np.meshgrid(u, v)
    pts = np.stack([r * np.cos(uu) * np.sin(vv),
                    r * np.sin(uu) * np.sin(vv),
                    r * np.cos(vv)], axis=-1)
    faces = []
    rows, cols = pts.shape[:2]
    verts = pts.reshape(-1, 3)
    for i in range(rows - 1):
        for j in range(cols):
            j2 = (j + 1) % cols
            a, b = i * cols + j, i * cols + j2
            c, d = (i + 1) * cols + j, (i + 1) * cols + j2
            faces += [(a, b, d), (a, d, c)]
    return verts, np.array(faces)


def _capsule(r, half, n=10):
    """Capsule along +z: cylinder wall + two hemispherical caps."""
    verts_s, _ = _uv_sphere(r, n)
    top = verts_s[verts_s[:, 2] >= -1e-9] + [0, 0, half]
    bot = verts_s[verts_s[:, 2] <= 1e-9] - [0, 0, half]
    u = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    ring_t = np.stack([r * np.cos(u), r * np.sin(u),
                       np.full_like(u, half)], axis=-1)
    ring_b = ring_t - [0, 0, 2 * half]
    verts = np.concatenate([top, bot, ring_t, ring_b])
    return verts, _convexish_faces(verts)


def _cylinder(r, half, n=12):
    u = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([r * np.cos(u), r * np.sin(u), np.zeros_like(u)],
                    axis=-1)
    top = ring + [0, 0, half]
    bot = ring - [0, 0, half]
    verts = np.concatenate([top, bot, [[0, 0, half]], [[0, 0, -half]]])
    ct, cb = 2 * n, 2 * n + 1
    faces = []
    for j in range(n):
        j2 = (j + 1) % n
        faces += [(j, j2, n + j2), (j, n + j2, n + j)]      # wall
        faces += [(ct, j, j2), (cb, n + j2, n + j)]          # caps
    return verts, np.array(faces)


def _box(size):
    sx, sy, sz = size
    verts = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                      for z in (-sz, sz)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return verts, np.array(faces)


def _convexish_faces(verts):
    """Triangulate a point cloud via its convex hull (scipy), falling back
    to a crude fan if scipy is unavailable."""
    try:
        from scipy.spatial import ConvexHull
    except ImportError:
        n = len(verts)
        return np.array([(0, i, i + 1) for i in range(1, n - 1)])
    return ConvexHull(verts).simplices


def _geom_mesh(gtype, size):
    if gtype == SPHERE:
        return _uv_sphere(size[0])
    if gtype == CAPSULE:
        return _capsule(size[0], size[1])
    if gtype == CYLINDER:
        return _cylinder(size[0], size[1])
    if gtype == BOX:
        return _box(size)
    return None


def _model_meshes(model):
    """Static per-geom unit meshes (host-side, computed once)."""
    size = np.asarray(model.geom_size)
    return [_geom_mesh(model.geom_type[g], size[g])
            for g in range(model.ngeom)]


def _shade(base, normals):
    lam = np.clip(normals @ _LIGHT, 0.0, 1.0)[:, None]
    amb = 0.35
    rgb = np.asarray(base)[None, :] * (amb + (1 - amb) * lam)
    return np.clip(rgb, 0, 1)


def draw_model(ax, model, geom_xpos, geom_xmat, meshes=None, alpha=1.0):
    """Draw every geom of one frame (``geom_xpos`` (ngeom, 3), ``geom_xmat``
    (ngeom, 3, 3), from ``trajectory_geometry``) as shaded meshes."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    gx, gm = np.asarray(geom_xpos), np.asarray(geom_xmat)
    size = np.asarray(model.geom_size)
    if meshes is None:
        meshes = _model_meshes(model)

    polys, colors = [], []
    for g in range(model.ngeom):
        t = model.geom_type[g]
        if t == PLANE:
            n_sq, s = 8, min(max(float(size[g][0]), 1.0), 4.0)
            xs = np.linspace(-s, s, n_sq + 1)
            for i in range(n_sq):
                for j in range(n_sq):
                    quad = np.array([[xs[i], xs[j], 0], [xs[i + 1], xs[j], 0],
                                     [xs[i + 1], xs[j + 1], 0],
                                     [xs[i], xs[j + 1], 0]])
                    polys.append(gx[g][None] + quad @ gm[g].T)
                    shade = 0.82 if (i + j) % 2 else 0.70
                    colors.append((shade, shade, shade))
            continue
        mesh = meshes[g]
        if mesh is None:
            continue
        verts, faces = mesh
        world = gx[g][None] + verts @ gm[g].T
        tri = world[faces]                                  # (F, 3, 3)
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
        # orient normals outward from the geom center
        cent = tri.mean(axis=1) - gx[g][None]
        flip = np.sign(np.sum(n * cent, axis=-1))[:, None]
        n = n * np.where(flip == 0, 1.0, flip)
        base = _PALETTE[model.geom_body[g] % len(_PALETTE)]
        polys.extend(tri)
        colors.extend(_shade(base, n))

    ax.add_collection3d(Poly3DCollection(polys, facecolors=colors,
                                         edgecolors="none", alpha=alpha))


def _frame_bounds(geom_xpos):
    lo = geom_xpos.reshape(-1, 3).min(axis=0) - 0.5
    hi = geom_xpos.reshape(-1, 3).max(axis=0) + 0.5
    return 0.5 * (lo + hi), max(float((hi - lo).max()) * 0.5, 0.6)


def _write_video(path, frames, fps):
    """mp4 via OpenCV; .gif via PIL."""
    if path.endswith(".gif"):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def render_trajectory(model, qpos_seq, save_dir=None, gif_path=None,
                      video_path=None, fps=20, elev=18, azim=-60,
                      max_frames=200, dpi=110, device=None, body_pos=None):
    """Render a qpos sequence: mp4 to ``video_path`` (OpenCV), a GIF to
    ``gif_path``, and/or per-frame PNGs to ``save_dir`` -> the number of
    frames.  The geometry is computed on ``device`` (default: the GPU);
    ``body_pos`` as in ``trajectory_geometry``.  Without matplotlib nothing
    is drawn and 0 is returned."""
    ok, reason = drawing_available()
    if not ok:
        print(f"{reason}: no frames drawn")
        return 0
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    qpos_seq = np.asarray(qpos_seq)
    stride = max(1, len(qpos_seq) // max_frames)
    gx, gm = trajectory_geometry(model, qpos_seq[::stride], device,
                                 body_pos=body_pos)
    meshes = _model_meshes(model)
    center, radius = _frame_bounds(gx)
    want_frames = gif_path is not None or video_path is not None
    frames = []
    for k, t in enumerate(range(0, len(qpos_seq), stride)):
        fig = plt.figure(figsize=(6, 4.5))
        ax = fig.add_subplot(projection="3d")
        draw_model(ax, model, gx[k], gm[k], meshes=meshes)
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(max(center[2] - radius, -0.05), center[2] + radius)
        ax.set_box_aspect((1, 1, 1))
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        ax.set_title(f"t = {t}", fontsize=9)
        fig.tight_layout(pad=0.1)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            fig.savefig(os.path.join(save_dir, f"frame_{t:05d}.png"),
                        dpi=dpi)
        if want_frames:
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3]
                          .copy())
        plt.close(fig)

    if frames:
        if gif_path is not None:
            _write_video(gif_path, frames, fps)
        if video_path is not None:
            _write_video(video_path, frames, fps)
    return max(len(frames),
               len(range(0, len(qpos_seq), stride)) if save_dir else 0)


def render_state(model, qpos, device=None, body_pos=None):
    """One configuration drawn into a 4 x 3 inch figure -> an RGB array
    (H, W, 3) uint8 (``GymEnv.render``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    gx, gm = trajectory_geometry(model, np.asarray(qpos)[None], device,
                                 body_pos=body_pos)
    fig = plt.figure(figsize=(4, 3))
    ax = fig.add_subplot(projection="3d")
    draw_model(ax, model, gx[0], gm[0])
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def _policy_action(policy, obs, mean_action):
    a, info = policy.get_action(obs)
    return info["evaluation"] if mean_action else a


def visualize_policy(env, policy, num_episodes=1, horizon=None,
                     mean_action=True, save_dir="policy_vis", seed=123,
                     video_format="mp4"):
    """Roll the policy and render each episode as ``episode_<i>.<format>``
    in ``save_dir`` ('mp4' through OpenCV, or 'gif') -> the number of
    frames written.  The functional env is stepped directly, one
    environment on its device; each episode's qpos sequence is also
    written to ``episode_<i>_qpos.npy``.  An external host env renders
    itself (its ``render()``, one frame per step)."""
    os.makedirs(save_dir, exist_ok=True)
    if getattr(env, "_external", False):
        return _visualize_external(env, policy, num_episodes, horizon,
                                   mean_action, save_dir, seed,
                                   video_format)
    fenv = env.env if hasattr(env, "env") and hasattr(env.env, "reset") \
        else env
    horizon = horizon or fenv.horizon
    gen = make_generator(seed, fenv.device)
    n_frames = 0
    for ep in range(num_episodes):
        state = fenv.reset(1, gen)
        qpos_seq = [state.physics.qpos[0]]
        for _ in range(horizon):
            act = _policy_action(
                policy, state.obs[0].cpu().numpy(), mean_action)
            act = torch.as_tensor(np.asarray(act), dtype=state.obs.dtype,
                                  device=fenv.device).reshape(1, -1)
            state = fenv.step(state, act)
            qpos_seq.append(state.physics.qpos[0])
            if bool(state.done[0]):
                break
        qpos_seq = torch.stack(qpos_seq).cpu().numpy()
        np.save(os.path.join(save_dir, f"episode_{ep}_qpos.npy"), qpos_seq)
        body_pos = fenv._body_pos(state.scenery)
        path = os.path.join(save_dir, f"episode_{ep}.{video_format}")
        kw = {"video_path" if video_format == "mp4" else "gif_path": path}
        n_frames += render_trajectory(fenv.model, qpos_seq,
                                      device=fenv.device, body_pos=body_pos,
                                      **kw)
    return n_frames


def _visualize_external(env, policy, num_episodes, horizon, mean_action,
                        save_dir, seed, video_format):
    horizon = horizon or env.horizon
    n_frames = 0
    for ep in range(num_episodes):
        o = env.reset(seed=seed + ep)
        frames = [env.env.render()]
        for _ in range(horizon):
            o, _, done, _ = env.step(_policy_action(policy, o, mean_action))
            frames.append(env.env.render())
            if done:
                break
        _write_video(os.path.join(save_dir, f"episode_{ep}.{video_format}"),
                     frames, 20)
        n_frames += len(frames)
    return n_frames
