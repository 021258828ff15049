"""Offscreen rendering (CPU): the port's ``utils/render.py`` against the
JAX package's.

- The geometry: one batched forward-kinematics call over all frames
  against the JAX ``fwd_kinematics`` of each frame, float64 models, every
  geom's world position and orientation at 1e-6.
- The frames: ``render_trajectory`` of the same qpos sequence through both
  packages, per-frame PNGs compared pixel by pixel: mean absolute
  difference at most 1/255 (the packages' float32 geometry differs in the
  last bits, which can move an edge pixel).
- The mp4, GIF and PNG outputs and ``visualize_policy``, as
  ``tests/test_render.py`` checks them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch import envs as tenvs
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy
from mjrl_tpu_torch.utils import render


@pytest.fixture
def drawing():
    """The drawing tests need matplotlib (and PIL to read frames back)."""
    pytest.importorskip("matplotlib")
    return pytest.importorskip("PIL.Image")

GEOM_TOL = 1e-6


def qpos_sequence(env_id, T, seed):
    """T configurations around the model's qpos0."""
    model = tenvs.make(env_id, device="cpu").model
    rng = np.random.RandomState(seed)
    return model.qpos0 + rng.uniform(-0.6, 0.6, (T, model.nq))


@pytest.mark.parametrize("env_id", ["mjrl_point_mass-v0",
                                    "mjrl_reacher_7dof-v0", "Hopper-v3"])
def test_batched_geometry_matches_jax_per_frame(env_id):
    q = qpos_sequence(env_id, 6, 0)
    tmodel = tenvs.make(env_id, dtype=torch.float64, device="cpu").model
    jmodel = jenvs.make(env_id, dtype=jnp.float64).model
    gx, gm = render.trajectory_geometry(tmodel, q, device="cpu",
                                        dtype=torch.float64)
    assert gx.shape == (6, tmodel.ngeom, 3)
    assert gm.shape == (6, tmodel.ngeom, 3, 3)
    fk = jax.jit(lambda qq: fwd_kinematics(jmodel, qq))
    for t in range(len(q)):
        data = fk(jnp.asarray(q[t]))
        np.testing.assert_allclose(gx[t], np.asarray(data.geom_xpos),
                                   rtol=GEOM_TOL, atol=GEOM_TOL)
        np.testing.assert_allclose(gm[t], np.asarray(data.geom_xmat),
                                   rtol=GEOM_TOL, atol=GEOM_TOL)


def frames(image, directory):
    names = sorted(os.listdir(directory))
    return names, [np.asarray(image.open(os.path.join(directory, n))
                              .convert("RGB"), np.float64) for n in names]


@pytest.mark.parametrize("env_id,T", [("mjrl_point_mass-v0", 4),
                                      ("mjrl_reacher_7dof-v0", 3)])
def test_frames_match_the_jax_frames(tmp_path, drawing, env_id, T):
    from mjrl_tpu.utils import render as jrender
    q = qpos_sequence(env_id, T, 1)
    jrender.render_trajectory(jenvs.make(env_id).model, q,
                              save_dir=str(tmp_path / "jax"))
    n = render.render_trajectory(tenvs.make(env_id, device="cpu").model, q,
                                 save_dir=str(tmp_path / "port"),
                                 device="cpu")
    assert n == T
    jn, jf = frames(drawing, tmp_path / "jax")
    tn, tf = frames(drawing, tmp_path / "port")
    assert jn == tn and len(tn) == T
    for a, b in zip(tf, jf):
        assert a.shape == b.shape
        assert np.mean(np.abs(a - b)) <= 1.0


def test_render_trajectory_gif(tmp_path, drawing):
    e = GymEnv("mjrl_point_mass-v0", device="cpu")
    qpos_seq = np.linspace([-1, -1], [1, 1], 8)
    gif = str(tmp_path / "t.gif")
    n = render.render_trajectory(e.env.model, qpos_seq, gif_path=gif,
                                 device="cpu")
    assert n == 8
    assert os.path.getsize(gif) > 1000
    assert drawing.open(gif).n_frames == 8


def test_render_frames_dir(tmp_path, drawing):
    e = GymEnv("mjrl_reacher_7dof-v0", device="cpu")
    render.render_trajectory(e.env.model, np.zeros((3, 7)),
                             save_dir=str(tmp_path), device="cpu")
    assert len(list(tmp_path.glob("frame_*.png"))) == 3


def test_visualize_policy(tmp_path, drawing):
    pytest.importorskip("cv2")
    e = GymEnv("mjrl_point_mass-v0", device="cpu")
    pol = Policy(GaussianMLP(6, 2, hidden_sizes=(8,), device="cpu"), seed=0)
    n = render.visualize_policy(e, pol, num_episodes=1, horizon=5,
                                save_dir=str(tmp_path))
    assert n >= 5
    assert os.path.getsize(tmp_path / "episode_0.mp4") > 1000
    assert np.load(tmp_path / "episode_0_qpos.npy").shape == (6, 2)
    n = render.visualize_policy(e, pol, num_episodes=1, horizon=3,
                                save_dir=str(tmp_path), video_format="gif")
    assert n == 4 and os.path.exists(tmp_path / "episode_0.gif")
    # through the wrapper, and one frame of the current state
    assert e.visualize_policy(pol, horizon=2, save_dir=str(tmp_path / "w"),
                              mode="evaluation") == 3
    img = e.render()
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3


def test_without_matplotlib_nothing_is_drawn(tmp_path, monkeypatch):
    monkeypatch.setattr(render, "drawing_available",
                        lambda: (False, "matplotlib is not installed"))
    e = GymEnv("mjrl_swimmer-v0", device="cpu")
    pol = Policy(GaussianMLP(e.observation_dim, e.action_dim,
                             hidden_sizes=(8,), device="cpu"), seed=0)
    assert render.visualize_policy(e, pol, horizon=4,
                                   save_dir=str(tmp_path)) == 0
    assert sorted(os.listdir(tmp_path)) == ["episode_0_qpos.npy"]
    assert np.load(tmp_path / "episode_0_qpos.npy").shape == (5, 7)
