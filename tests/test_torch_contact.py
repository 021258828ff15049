"""Port vs JAX package: the contact / RK4 branch of the planar step.

``mjrl_tpu_torch.physics.planar`` holds the plain PyTorch version of the
contact kernel.  Here it is held to the JAX package (float64, ``jax.vmap``
over the batch) level by level, on Hopper (RK4, capsule-capsule condim-1
pairs), Walker2d (RK4) and HalfCheetah (Euler, joint springs):

- constraint rows (J, aref, b, active, R) at 1e-12 against the eagerly
  evaluated JAX function: the same component arithmetic in the same order,
  only elementary functions differ;
- one dual solve, cold (50 sweeps from zero) and warm (15 sweeps from the
  cold impulses), at 1e-10: the port sums the matrix-vector products with
  ``torch.sum`` where JAX uses a matmul, so the association differs and 50
  sweeps of a projected iteration carry that along;
- one whole control step at 1e-9 (positions) / 1e-8 relative to the
  velocity scale: 16 chained solves (4 substeps x 4 RK4 stages).

States lie off the contact and limit boundaries (see ``contact_states``):
exactly on one, ``depth > 0`` or the APGD restart test could legitimately
differ between two correct implementations.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import planar as jplanar
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import ELLIPTIC as JAX_ELLIPTIC
from mjrl_tpu_torch.ops import cuda_planar
from mjrl_tpu_torch.physics import planar as tplanar

from test_torch_kernel_host import (CONTACT_MODELS, GOLDEN, MJCF,
                                    cheetah_explosion_states, contact_params,
                                    contact_states)

KINDS = ("resting", "penetrating", "limits")


def jax_params(name, cone=None):
    mb = jax_load_mjcf(os.path.join(MJCF, CONTACT_MODELS[name][0]))
    if cone == "elliptic":
        mb.opt["cone"] = JAX_ELLIPTIC
    return jplanar.extract_planar(
        mb.finalize(jnp.float64, solver="newton"))


def all_states(p, qpos0, B=3):
    parts = [contact_states(p, qpos0, k, B=B, seed=i)
             for i, k in enumerate(KINDS)]
    return tuple(np.concatenate([x[i] for x in parts]) for i in range(3))


@pytest.fixture(scope="module")
def hopper():
    pt, qpos0 = contact_params("hopper")
    return jax_params("hopper"), pt, qpos0


def test_planar_params_have_the_contact_tables(hopper):
    pj, pt, _ = hopper
    assert tplanar.needs_contact_path(pt)
    assert tplanar.n_planar_rows(pt) == jplanar.n_planar_rows(pj) == 38
    assert (len(pt.contacts_pt), len(pt.contacts_cc)) == (8, 3)
    assert tplanar._planar_soc(pt) is None
    assert (tplanar.SWEEPS, tplanar.SWEEPS_WARM, tplanar.POWER_ITERS) \
        == (50, 15, 8)


def test_constraint_rows_match_jax(hopper):
    """J, aref_pos, b, active, R vs _constraint_rows_planar at 1e-12."""
    pj, pt, qpos0 = hopper
    q, v, _ = all_states(pt, qpos0)

    def jrows(qq, vv):
        ql = [qq[d] for d in range(pj.nv)]
        vl = [vv[d] for d in range(pj.nv)]
        return jplanar._constraint_rows_planar(
            pj, jplanar._planar_ctx(pj, ql), ql, vl)
    # eager, not jitted: the capsule-capsule rows divide by a determinant
    # that nearly cancels for near-parallel segments, where XLA's fused
    # arithmetic alone moves an entry by 3e-9
    ref = jax.vmap(jrows)(q, v)
    tq, tv = torch.tensor(q), torch.tensor(v)
    ql = [tq[:, d] for d in range(pt.nv)]
    vl = [tv[:, d] for d in range(pt.nv)]
    got = tplanar._constraint_rows(pt, tplanar._planar_ctx(pt, ql), ql, vl)
    assert tuple(got[0].shape) == (len(q), 38, 6)
    assert got[3].sum() > 10          # contacts and limits really active
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)


def test_contact_qacc_cold_and_warm_match_jax(hopper):
    """One dual solve from zero impulses (50 sweeps), then one warm-started
    from them (15 sweeps), vs JAX _contact_qacc at 1e-10 (relative to the
    acceleration scale)."""
    pj, pt, qpos0 = hopper
    q, v, u = all_states(pt, qpos0)
    jfn = jax.jit(jax.vmap(
        lambda qq, vv, uu, ll, sw: jplanar._contact_qacc(pj, qq, vv, uu, ll,
                                                         sw)[:3],
        in_axes=(0, 0, 0, 0, None)))
    lam0 = np.zeros((len(q), 38))
    r_cold = jfn(q, v, u, lam0, jnp.int32(50))
    r_warm = jfn(q, v, u, np.asarray(r_cold[2]), jnp.int32(15))
    tq, tv, tu = (torch.tensor(a) for a in (q, v, u))
    g_cold = tplanar._contact_qacc(pt, tq, tv, tu, torch.tensor(lam0), 50)
    g_warm = tplanar._contact_qacc(pt, tq, tv, tu, g_cold[2], 15)
    assert np.abs(np.asarray(r_cold[2])).max() > 1.0   # impulses at work
    for got, ref in ((g_cold, r_cold), (g_warm, r_warm)):
        for g, r in zip(got[:3], ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-10,
                                       atol=1e-10 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("name,cone", [("hopper", None), ("walker2d", None),
                                       ("half_cheetah", None),
                                       ("hopper", "elliptic")],
                         ids=["hopper", "walker2d", "half_cheetah",
                              "hopper_elliptic"])
def test_control_step_matches_jax(name, cone):
    """step_n_arrays, one control step (frame_skip substeps), vs the JAX
    step_n_arrays: positions at 1e-9, velocities at 1e-9 relative to the
    largest velocity of the state set (the limit states move at ~5 rad/s and
    the explosion states at ~100)."""
    pt, qpos0 = contact_params(name, cone)
    pj = jax_params(name, cone)
    n = CONTACT_MODELS[name][1]
    q, v, u = all_states(pt, qpos0)
    if name == "half_cheetah":
        eq, ev, eu = cheetah_explosion_states()
        q, v, u = (np.concatenate(x) for x in ((q, eq), (v, ev), (u, eu)))
    if cone == "elliptic":
        assert tplanar._planar_soc(pt) == jplanar._planar_soc(pj)
        assert tplanar._planar_soc(pt)[1] == 8
    rq, rv = jax.jit(jax.vmap(
        lambda qq, vv, uu: jplanar.step_n_arrays(pj, qq, vv, uu, n)))(q, v, u)
    rq, rv = np.asarray(rq), np.asarray(rv)
    gq, gv = cuda_planar.cuda_step_n_batched(
        pt, torch.tensor(q), torch.tensor(v), torch.tensor(u), n)
    gq, gv = gq.numpy(), gv.numpy()
    # the last captured half-cheetah state has already exploded (|qvel|
    # 4e5) and one more control step takes it past 1e150: nothing to compare
    # digit for digit, but both sides must hand the env's divergence rescue
    # the same row
    blown = ~(np.abs(rv) < 1e10).all(-1)
    assert blown.sum() == (1 if name == "half_cheetah" else 0)
    assert list(~(np.abs(gv) < 1e10).all(-1)) == list(blown)
    gq, gv, rq, rv = (a[~blown] for a in (gq, gv, rq, rv))
    assert np.abs(rv - v[~blown]).max() > 0.5    # the step did something
    np.testing.assert_allclose(gq, rq, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gv, rv, rtol=1e-9,
                               atol=1e-9 * max(1.0, np.abs(rv).max()))


@pytest.mark.parametrize("name", ["hopper", "walker2d"])
def test_cold_solve_matches_mujoco_goldens(name):
    """Constrained acceleration at the contact-active MuJoCo golden states:
    the gates the JAX package holds its own solver to
    (tests/test_solver.py): median relative error <= 2 %, 90th percentile
    <= 12 %."""
    pt, _ = contact_params(name)
    g = np.load(os.path.join(GOLDEN, f"contact_{name}.npz"))
    q, v, u = (torch.tensor(g[k][:25]) for k in ("qpos", "qvel", "ctrl"))
    lam0 = torch.zeros((25, tplanar.n_planar_rows(pt)), dtype=torch.float64)
    qacc = tplanar._contact_qacc(pt, q, v, u, lam0, tplanar.SWEEPS)[0].numpy()
    ref = g["qacc"][:25]
    errs = np.abs(qacc - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1.0)
    assert np.median(errs) < 0.02, np.sort(errs)[-5:]
    assert np.percentile(errs, 90) < 0.12, np.sort(errs)[-5:]
