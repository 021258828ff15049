"""Port vs JAX package: the model-accelerated NPG runner's own logic on
the point mass (CPU, float64).

Both runners are handed the same real paths (their ``sample_data_batch``
and ``evaluate_policy`` return the same numpy paths), start from the same
ensemble weights and fit with the JAX fit's own permutations (from each
member's key, as ``test_torch_nn_dynamics.py`` draws them).  The NPG step
on imagined rollouts (held to the JAX package's in
``test_torch_model_accel_npg.py``) is replaced in both by a recorder that
keeps its start states and marks the policy (log_std set to minus a
tenth of the update's number), so that the best policy can be told.

Compared over three outer iterations, with a buffer small enough that the
FIFO drops paths: the fit's data (the buffer) and the start states numpy
picks for each update (exact: the same global stream from the config's
seed), both ``start_state`` modes; the log keys; ``num_samples``,
``iter_samples``, ``rollout_score``, ``rollout_metric``, ``eval_score``
(exact); ``dyn_loss_gen_i`` (the slice of the freshest samples) and
``dyn_loss_i`` at 1e-9, the fits' tolerance; and the best policy kept.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.model_accel import model_accel_npg as jmanpg
from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
from mjrl_tpu.algos.model_accel.run_experiments import \
    run_model_accel_npg as jrun
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos.model_accel import model_accel_npg as tmanpg
from mjrl_tpu_torch.algos.model_accel import nn_dynamics as tnd
from mjrl_tpu_torch.algos.model_accel.run_experiments import \
    run_model_accel_npg as trun

from test_torch_baselines import jax_perms
from test_torch_nn_dynamics import (FIT_TOL, Float64Numpy, close, jax_tree,
                                    numpy_layers)

HERE = os.path.dirname(os.path.abspath(__file__))
OBS, ACT, HID, M = 6, 2, (16, 16), 3
LENGTH = 6                     # rows per real path: 5 transitions
EVAL_SCORES = [1.0, 3.0, 2.0]  # the second iteration's policy is the best


def job(start_state):
    with open(os.path.join(HERE, "..", "mjrl_tpu_torch", "algos",
                           "model_accel", "run_experiments", "configs",
                           "point_mass.json")) as f:
        job = json.load(f)
    job.update(num_iter=3, num_models=M, eval_rollouts=1, init_samples=18,
               iter_samples=12, hidden_size=list(HID), policy_size=[8],
               update_paths=5, inner_steps=2, fit_epochs=2, fit_mb_size=4,
               buffer_size=20, save_freq=1, horizon=5,
               start_state=start_state, buffer_frac=0.4)
    return job


def real_paths(num_samples, base_seed):
    rng = np.random.RandomState(base_seed)
    return [dict(observations=rng.normal(0, 0.5, (LENGTH, OBS)),
                 actions=rng.normal(0, 0.5, (LENGTH, ACT)),
                 rewards=rng.normal(-1.0, 0.3, LENGTH),
                 env_infos={"solved": rng.uniform(size=LENGTH) > 0.7})
            for _ in range(num_samples // LENGTH)]


def eval_paths(calls):
    def evaluate_policy(*args, **kwargs):
        calls.append(None)
        return [dict(rewards=np.full(4, EVAL_SCORES[len(calls) - 1] / 4))]
    return evaluate_policy


def start_weights(i):
    rng = np.random.RandomState(60 + i)
    tr = {"s_shift": rng.normal(0, 0.2, OBS),
          "s_scale": rng.uniform(0.5, 1.5, OBS),
          "a_shift": rng.normal(0, 0.2, ACT),
          "a_scale": rng.uniform(0.5, 1.5, ACT),
          "out_shift": rng.normal(0, 0.05, OBS),
          "out_scale": rng.uniform(0.05, 0.2, OBS)}
    return numpy_layers(50 + i, OBS + ACT, OBS, HID), tr


def jax_ensemble(*args, **kwargs):
    ens = jnd.WorldModelEnsemble(*args, **kwargs)
    for i, m in enumerate(ens):
        layers, tr = start_weights(i)
        m.dyn_params = jax_tree(layers)
        m.dyn_tr = jax_tree(tr)
        m.dyn_opt_state = m._dyn_opt.init(m.dyn_params)
    return ens


def port_ensemble(*args, **kwargs):
    ens = tnd.WorldModelEnsemble(*args, **{**kwargs,
                                           "dtype": torch.float64})
    for i, m in enumerate(ens):
        convert.world_model_from_numpy(m, *start_weights(i))
    return ens


def recorded_fit(cls, seen, perms=None):
    """cls's fit_dynamics, keeping the data it is given; on the JAX class
    (``perms`` None) each fit's permutations are drawn into ``seen``, and
    the port's takes them from there."""
    fit = cls.fit_dynamics

    def fit_dynamics(self, s, a, sp, fit_mb_size, fit_epochs,
                     max_steps=1e4, **kwargs):
        seen["data"].append(np.concatenate([s, a, sp], 1))
        if perms is None:
            seen["perms"].append(np.stack([
                jax_perms(jax.random.fold_in(m._key, 7), fit_epochs,
                          len(s)) for m in self.members]))
        else:
            kwargs["perms"] = perms.pop(0)
        return fit(self, s, a, sp, fit_mb_size, fit_epochs, max_steps,
                   **kwargs)
    return fit_dynamics


def recorded_update(seen, mark):
    def train_step(self, N, init_states=None, **kwargs):
        assert N == len(init_states)
        seen["init_states"].append(np.array(init_states))
        mark(self.policy, -0.1 * len(seen["init_states"]))
    return train_step


def jax_mark(policy, value):
    ls = np.full(ACT, value)
    policy.params = {**policy.params, "log_std": jax.numpy.asarray(ls)}


def port_mark(policy, value):
    with torch.no_grad():
        policy.params["log_std"].fill_(value)


def run_both(monkeypatch, tmp_path, start_state):
    monkeypatch.setattr(jnd, "jnp", Float64Numpy())
    seen = {k: {"data": [], "perms": [], "init_states": [], "eval": []}
            for k in ("jax", "port")}
    for mod, ensemble, who in ((jrun, jax_ensemble, "jax"),
                               (trun, port_ensemble, "port")):
        monkeypatch.setattr(mod, "sample_data_batch",
                            lambda n, *a, base_seed, **k:
                            real_paths(n, base_seed))
        monkeypatch.setattr(mod, "evaluate_policy",
                            eval_paths(seen[who]["eval"]))
        monkeypatch.setattr(mod, "WorldModelEnsemble", ensemble)
    monkeypatch.setattr(jnd.WorldModelEnsemble, "fit_dynamics",
                        recorded_fit(jnd.WorldModelEnsemble, seen["jax"]))
    monkeypatch.setattr(tnd.WorldModelEnsemble, "fit_dynamics",
                        recorded_fit(tnd.WorldModelEnsemble, seen["port"],
                                     perms=seen["jax"]["perms"]))
    monkeypatch.setattr(jmanpg.ModelAccelNPG, "train_step",
                        recorded_update(seen["jax"], jax_mark))
    monkeypatch.setattr(tmanpg.ModelAccelNPG, "train_step",
                        recorded_update(seen["port"], port_mark))
    _, jlog = jrun.run(str(tmp_path / "jax"), job(start_state))
    _, tlog = trun.run(str(tmp_path / "port"), job(start_state),
                       device="cpu")
    return seen, jlog.log, tlog.log


@pytest.mark.parametrize("start_state", ["init", "buffer"])
def test_model_accel_runner_matches_jax_runner(monkeypatch, tmp_path,
                                               start_state):
    seen, want, got = run_both(monkeypatch, tmp_path, start_state)
    assert not seen["jax"]["perms"]      # the port took every fit's draws
    for k in ("data", "init_states"):
        assert len(seen["port"][k]) == len(seen["jax"][k]) \
            == (3 if k == "data" else 6)
        for tx, jx in zip(seen["port"][k], seen["jax"][k]):
            np.testing.assert_array_equal(tx, jx)
    # the FIFO buffer: 3, then 5 -> 4, then 6 -> 4 paths of 5 transitions
    assert [len(x) for x in seen["port"]["data"]] == [15, 20, 20]
    # "buffer": int(5 (1 - 0.4)) + 1 starts, and int(5 0.4) + 1 states
    n_up = 5 if start_state == "init" else 4 + 3
    assert seen["port"]["init_states"][0].shape == (n_up, OBS)

    assert sorted(got) == sorted(want)
    assert {f"dyn_loss_gen_{M - 1}", "rollout_metric", "eval_score"} \
        <= set(got)
    for k, v in want.items():
        if k.endswith("_time"):
            assert len(got[k]) == len(v) == 3
        elif k.startswith("dyn_loss"):
            close(got[k], v, FIT_TOL)
        else:
            assert got[k] == v, k
    assert got["num_samples"] == [18, 12, 12]

    kept = {}
    for who in ("jax", "port"):
        with open(tmp_path / who / "iterations" / "best_policy.pickle",
                  "rb") as f:
            kept[who] = np.asarray(pickle.load(f).params["log_std"])
    # the port's runner keeps its policy in float32
    close(kept["jax"], np.full(ACT, -0.4), 0.0)
    close(kept["port"], kept["jax"], 1e-7)
