"""The relocate demo maker and the DAPG relocate pipeline on the port alone
(CPU, float32 as the example runs).

- The expert's numpy oracles against the port's forward kinematics: the
  palm site's position and rotation at 1e-12 (float64 model), its
  Jacobian over the 8 pose dofs against central differences at 1e-6.
- The port's copy of the scripted expert gives the repo's expert's
  actions (``tools/relocate_expert.py``, numpy) on the same inputs.
- The demo maker at B 2 for 3 control steps: shapes, actions in [-1, 1],
  the rewards and goal flags the env gave, the initial env state.
- ``examples/torch_dapg_relocate.py`` at horizon 3: demos made in the run,
  BC for 2 epochs, one DAPG iteration of 4 paths, evaluation: finite
  statistics, the KL within the guard.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv
from mjrl_tpu_torch.physics.kinematics import body_frames, site_positions
from mjrl_tpu_torch.utils import relocate_demos
from mjrl_tpu_torch.utils.relocate_demos import (NumpyAdroitBackend,
                                                 RelocateExpert, make_demos)

from test_torch_mjcf_m9b import one_torch_thread  # noqa: E402,F401

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch_dapg_relocate.py")


def _palm(env, qpos):
    q = torch.tensor(qpos)[None]
    data = body_frames(env.model, q)
    return site_positions(env.model, data)[0, env._palm_sid].numpy(), data


def test_expert_oracles_match_the_port_kinematics():
    env = AdroitRelocateEnv(dtype=torch.float64, device="cpu")
    be = NumpyAdroitBackend(env)
    rng = np.random.RandomState(0)
    for _ in range(3):
        qpos = env.model.qpos0 + rng.uniform(-0.3, 0.3, env.model.nq)
        p, R, jp, jr = be.pose_and_jac(qpos)
        palm, data = _palm(env, qpos)
        np.testing.assert_allclose(p, palm, rtol=1e-12, atol=1e-12)
        sb = env.model.site_body[env._palm_sid]
        quat = env.model.site_quat[env._palm_sid]
        want_r = data.xmat[0, sb].numpy() @ relocate_demos._quat_mat(quat)
        np.testing.assert_allclose(R, want_r, atol=1e-12)
        eps = 1e-6
        for d in range(8):
            dq = np.zeros(env.model.nq)
            dq[d] = eps
            fd = (_palm(env, qpos + dq)[0] - _palm(env, qpos - dq)[0]) \
                / (2 * eps)
            np.testing.assert_allclose(jp[:, d], fd, atol=1e-6)
        g = be.qfrc_bias(qpos)
        assert g.shape == (8,) and np.isfinite(g).all()


def test_expert_copy_matches_the_repo_expert():
    ref = pytest.importorskip("tools.relocate_expert")
    env = AdroitRelocateEnv(dtype=torch.float64, device="cpu")
    be = NumpyAdroitBackend(env)
    ours, theirs = RelocateExpert(noise=0.1, seed=3), \
        ref.RelocateExpert(noise=0.1, seed=3)
    qpos = env.model.qpos0.copy()
    rng = np.random.RandomState(1)
    for t in range(6):
        ball = np.array([0.05, 0.1, 0.035]) + 0.002 * t
        target = np.array([0.1, -0.1, 0.25])
        kw = dict(b=0, fk_shadow=be.fk_shadow, qfrc_bias=be.qfrc_bias(qpos))
        a = ours.action(qpos, be.pose_and_jac, ball, target, **kw)
        b = theirs.action(qpos, be.pose_and_jac, ball, target, **kw)
        np.testing.assert_array_equal(a, b)
        qpos = qpos + 0.01 * rng.normal(size=qpos.shape)


def test_demo_maker_batch_of_two():
    env = AdroitRelocateEnv(device="cpu")
    demos, succ = make_demos(env, 2, horizon=3, batch=2,
                             successful_only=False)
    assert len(demos) == 2 and succ == 0
    for p in demos:
        assert p["observations"].shape == (3, 39)
        assert p["actions"].shape == (3, 30)
        assert np.abs(p["actions"]).max() <= 1.0
        assert p["rewards"].shape == (3,) and np.isfinite(p["rewards"]).all()
        assert p["env_infos"]["goal_achieved"].dtype == bool
        assert set(p["init_state"]) == {"qpos", "qvel", "obj_pos",
                                        "target_pos"}
        np.testing.assert_array_equal(p["observations"][0, :30],
                                      p["init_state"]["qpos"][:30])
    # the paths differ: the ball and the target were drawn per episode
    assert not np.array_equal(demos[0]["observations"],
                              demos[1]["observations"])
    # none succeeds in 3 steps: only the successful are kept by default
    assert make_demos(env, 2, horizon=3, batch=2)[0] == []


def test_dapg_relocate_example_small():
    spec = importlib.util.spec_from_file_location("torch_dapg_relocate",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--make_demos", "2",
                    "--keep_all_demos", "--horizon", "3", "--bc_epochs",
                    "2", "--dapg_iters", "1", "--ntraj", "4",
                    "--eval_episodes", "2"])
    assert len(out["demo_paths"]) == 2
    log = out["dapg"].logger.log
    for k, vals in log.items():
        assert len(vals) == 1 and np.all(np.isfinite(vals)), k
    agent = out["dapg"]
    assert log["kl_dist"][0] <= agent.kl_guard * agent.n_step_size / 2 \
        * (1 + 1e-6)
    for k in ("bc_return", "final_return"):
        assert np.isfinite(out[k]), k
    assert np.isfinite(out["policy"].get_param_values()).all()
    with pytest.raises(NotImplementedError, match="cross_eval_relocate"):
        mod.main(["--device", "cpu", "--cross_eval_episodes", "1"])
