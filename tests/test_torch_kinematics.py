"""Port vs JAX package: spatial math and forward kinematics (CPU, float64).

- ``physics/math.py``: every helper on numpy-seeded batches against the
  JAX package's (vmapped where the JAX function takes one item), 1e-12
  absolute.
- ``fwd_kinematics`` on the point mass, the 7-DoF reacher and the
  ``ball.npz`` tree (two ball joints and a hinge): every field against the
  JAX package's at 1e-12, per-row ``site_pos`` included (the JAX envs move
  the target site by patching the model per episode); and against MuJoCo's
  golden xpos / ximat / xanchor at the JAX tests' tolerances
  (``test_physics_golden.py``: 1e-6; ``test_ball.py``: 1e-10).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import assets as jassets
from mjrl_tpu.physics import math as jm
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu_torch.envs import assets as tassets
from mjrl_tpu_torch.physics import math as tm
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-12
N = 16


def _rng_inputs():
    rng = np.random.RandomState(4)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = (1.0, 0, 0, 0)
    q[1] = (-0.2, 0.9, 0.3, -0.1)
    q[1] /= np.linalg.norm(q[1])
    q2 = rng.normal(size=(N, 4))
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    v = rng.normal(size=(N, 3))
    w = rng.normal(size=(N, 3))
    ax = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ang = rng.uniform(-4, 4, N)
    s6, t6 = rng.normal(size=(N, 6)), rng.normal(size=(N, 6))
    d = rng.uniform(0.1, 2.0, (N, 3))
    mass = rng.uniform(0.1, 3.0, N)
    return dict(q=q, q2=q2, v=v, w=w, ax=ax, ang=ang, s6=s6, t6=t6, d=d,
                mass=mass)


MATH = {
    "quat_to_mat": lambda m, x: m.quat_to_mat(x["q"]),
    "quat_mul": lambda m, x: m.quat_mul(x["q"], x["q2"]),
    "quat_rotate": lambda m, x: m.quat_rotate(x["q"], x["v"]),
    "axis_angle_quat": lambda m, x: m.axis_angle_quat(x["ax"], x["ang"]),
    "quat_inv": lambda m, x: m.quat_inv(x["q"]),
    "quat_to_rotvec": lambda m, x: m.quat_to_rotvec(x["q"]),
    "skew": lambda m, x: m.skew(x["v"]),
    "mat_mul": lambda m, x: m.mat_mul(m.quat_to_mat(x["q"]),
                                      m.quat_to_mat(x["q2"])),
    "mat_vec": lambda m, x: m.mat_vec(m.quat_to_mat(x["q"]), x["v"]),
    "mat_t_vec": lambda m, x: m.mat_t_vec(m.quat_to_mat(x["q"]), x["v"]),
    "rot_diag_rot_t": lambda m, x: m.rot_diag_rot_t(m.quat_to_mat(x["q"]),
                                                    x["d"]),
    "cross": lambda m, x: m.cross(x["v"], x["w"]),
    "motion_cross": lambda m, x: m.motion_cross(x["s6"], x["t6"]),
    "force_cross": lambda m, x: m.force_cross(x["s6"], x["t6"]),
    "point_velocity": lambda m, x: m.point_velocity(x["s6"], x["v"]),
}


@pytest.mark.parametrize("name", list(MATH))
def test_math_helper_matches_jax(name):
    x = _rng_inputs()
    got = MATH[name](tm, {k: torch.tensor(a) for k, a in x.items()})
    want = MATH[name](jm, {k: jnp.asarray(a) for k, a in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_mat_to_quat_and_spatial_inertia_match_jax():
    """The two helpers the JAX package writes for one item, vmapped."""
    x = _rng_inputs()
    mats = jax.vmap(jm.quat_to_mat)(jnp.asarray(x["q"]))
    want = jax.vmap(jm.mat_to_quat)(mats)
    got = tm.mat_to_quat(torch.tensor(np.asarray(mats)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    iw = jax.vmap(jm.rot_diag_rot_t)(mats, jnp.asarray(x["d"]))
    want = jax.vmap(jm.spatial_inertia)(jnp.asarray(x["mass"]), iw,
                                        jnp.asarray(x["v"]))
    got = tm.spatial_inertia(torch.tensor(x["mass"]),
                             torch.tensor(np.asarray(iw)),
                             torch.tensor(x["v"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _ball_xml():
    return str(np.load(os.path.join(GOLDEN, "ball.npz"),
                       allow_pickle=True)["xml"])


MODELS = {
    "point_mass": (lambda: jassets.point_mass_model().finalize(jnp.float64),
                   lambda: tassets.point_mass_model(solver="penalty"),
                   (-1.5, 1.5)),
    "reacher": (lambda: jassets.reacher_model().finalize(jnp.float64),
                lambda: tassets.reacher_model(solver="penalty"),
                (-2.5, 2.0)),
    "ball": (lambda: jax_load_mjcf(xml_string=_ball_xml()).finalize(
        jnp.float64), lambda: load_mjcf(xml_string=_ball_xml()).finalize(),
        None),
}
FIELDS = ("xpos", "xmat", "xipos", "ximat", "xanchor", "xaxis", "site_xpos",
          "geom_xpos", "geom_xmat")


@pytest.fixture(scope="module", params=list(MODELS))
def kinematics(request):
    jbuild, tbuild, qrange = MODELS[request.param]
    jmodel, tmodel_ = jbuild(), tbuild()
    rng = np.random.RandomState(8)
    if qrange is None:          # ball.npz: the golden configurations
        qpos = np.load(os.path.join(GOLDEN, "ball.npz"))["qpos"][:N]
    else:
        qpos = rng.uniform(*qrange, (N, tmodel_.nq))
    site_pos = (np.asarray(tmodel_.site_pos)[None]
                + rng.uniform(-0.3, 0.3, (N, tmodel_.nsite, 3)))

    def jfk(q, sp):
        return jax_fk(jmodel.replace(site_pos=sp), q)

    jd = jax.jit(jax.vmap(jfk))(jnp.asarray(qpos), jnp.asarray(site_pos))
    td = fwd_kinematics(tmodel_, torch.tensor(qpos), torch.tensor(site_pos))
    td0 = fwd_kinematics(tmodel_, torch.tensor(qpos))
    return request.param, jd, td, td0, tmodel_


@pytest.mark.parametrize("field", FIELDS)
def test_fwd_kinematics_matches_jax(kinematics, field):
    name, jd, td, _, _ = kinematics
    got, want = getattr(td, field).numpy(), np.asarray(getattr(jd, field))
    assert got.shape == want.shape, (name, field)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                               err_msg=f"{name} {field}")


def test_model_site_pos_without_rows(kinematics):
    """Without ``site_pos`` the model's own site positions are used."""
    _, _, td, td0, tmodel_ = kinematics
    sb = list(tmodel_.site_body)
    local = torch.tensor(np.asarray(tmodel_.site_pos))
    expect = td0.xpos[:, sb] + torch.matmul(
        td0.xmat[:, sb], local.unsqueeze(-1)).squeeze(-1)
    np.testing.assert_allclose(td0.site_xpos.numpy(), expect.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(td0.xpos.numpy(), td.xpos.numpy(), atol=0)


@pytest.mark.parametrize("name", ["point_mass", "reacher"])
def test_fwd_kinematics_matches_mujoco_golden(name):
    """MuJoCo's golden xpos / xipos / site_xpos at the JAX test's 1e-6."""
    g = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    tmodel_ = MODELS[name][1]()
    d = fwd_kinematics(tmodel_, torch.tensor(g["qpos"][:20]))
    massive = np.asarray(g["body_mass"]) > 1e-12
    np.testing.assert_allclose(d.xpos.numpy(), g["xpos"][:20], atol=1e-6)
    np.testing.assert_allclose(d.xipos.numpy()[:, massive],
                               g["xipos"][:20][:, massive], atol=1e-6)
    np.testing.assert_allclose(d.site_xpos.numpy(), g["site_xpos"][:20],
                               atol=1e-6)
    np.testing.assert_allclose(d.geom_xpos.numpy(), g["geom_xpos"][:20],
                               atol=1e-6)


def test_ball_fwd_kinematics_matches_mujoco_golden():
    """ball.npz: xpos and xanchor at the JAX test's 1e-10.  ximat is held
    through the world inertia tensor ximat diag(I) ximat^T, which does not
    depend on the sign and order of the principal axes MuJoCo's compiler
    picked (the JAX test does not compare ximat)."""
    g = np.load(os.path.join(GOLDEN, "ball.npz"), allow_pickle=True)
    model = MODELS["ball"][1]()
    d = fwd_kinematics(model, torch.tensor(g["qpos"]))
    np.testing.assert_allclose(d.xpos.numpy(), g["xpos"], atol=1e-10)
    np.testing.assert_allclose(d.xanchor.numpy(), g["xanchor"], atol=1e-10)

    def world_inertia(ximat, inertia):
        return np.einsum("...ij,...j,...kj->...ik", ximat, inertia, ximat)

    np.testing.assert_allclose(
        world_inertia(d.ximat.numpy(), model.body_inertia),
        world_inertia(g["ximat"], g["body_inertia"]), atol=1e-9)
