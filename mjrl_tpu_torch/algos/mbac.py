"""MBAC: MPC-as-expert DAgger-style distillation (counterpart of
``mjrl_tpu/algos/mbac.py``).

Per ``train_step``: roll out *policy* actions in the real env, one
environment at a time, while labelling every visited state with the MPC
expert's action (``MPCActor``, which shoots its candidates through the
batched real env); push the labelled paths into a FIFO trajectory buffer
capped at ``buffer_size`` paths; then behaviour-clone the policy to the
expert actions with BC's Adam, or the optimizer a factory passed as
``optimizer=`` builds (as in ``BC``).
"""

import numpy as np

from mjrl_tpu_torch.algos.behavior_cloning import BC
from mjrl_tpu_torch.envs.gym_env import GymEnv
from mjrl_tpu_torch.models.mpc_actor import MPCActor


class MBAC(BC):
    def __init__(self,
                 env_name,
                 policy,
                 expert_paths=None,
                 epochs=5,
                 batch_size=64,
                 lr=1e-3,
                 optimizer=None,
                 loss_type="MSE",
                 seed=123,
                 buffer_size=50,
                 mpc_params=None,
                 save_logs=True,
                 device=None):
        super().__init__(expert_paths=expert_paths, policy=policy,
                         epochs=epochs, batch_size=batch_size, lr=lr,
                         optimizer=optimizer, loss_type=loss_type,
                         save_logs=save_logs, device=device)
        self.expert_paths = [] if self.expert_paths is None \
            else self.expert_paths
        self.buffer_size = buffer_size

        self.env = GymEnv(env_name, device=self.device)
        self.env.reset(seed=seed)
        if mpc_params is None:
            mean = np.zeros(self.env.action_dim)
            sigma = 1.0 * np.ones(self.env.action_dim)
            filter_coefs = [sigma, 0.05, 0.0, 0.0]
            mpc_params = dict(env=GymEnv(env_name, device=self.device),
                              H=10, paths_per_cpu=25, num_cpu=1,
                              kappa=10.0, gamma=1.0,
                              mean=mean, filter_coefs=filter_coefs,
                              seed=seed)
        else:
            mpc_params["env"] = GymEnv(env_name, device=self.device)
            mpc_params["seed"] = seed
        self.mpc_params = mpc_params
        self.mpc_policy = MPCActor(**mpc_params)

    def collect_paths(self, num_traj=10, mode="policy", horizon=None,
                      render=False):
        """Step the real env with policy (or MPC) actions, labelling every
        state with the MPC expert's action."""
        horizon = self.env.horizon if horizon is None else horizon
        paths = []
        for _ in range(num_traj):
            self.env.reset()
            obs, act_pi, act_mpc, rew, states = [], [], [], [], []
            for t in range(horizon):
                o = self.env.get_obs()
                s = self.env.get_env_state()
                a_pi = self.policy.get_action(o)[0]
                a_mpc = self.mpc_policy.get_action(s)
                a = a_pi if mode == "policy" else a_mpc
                next_o, r, done, _ = self.env.step(a)
                obs.append(o)
                rew.append(r)
                states.append(s)
                act_pi.append(a_pi)
                act_mpc.append(a_mpc)
                if done:
                    break
            paths.append(dict(observations=np.array(obs),
                              actions=np.array(act_pi),
                              expert_actions=np.array(act_mpc),
                              rewards=np.array(rew),
                              states=states))
        return paths

    def add_paths_to_buffer(self, paths):
        """FIFO trajectory buffer."""
        for path in paths:
            self.expert_paths.append(path)
        if len(self.expert_paths) > self.buffer_size:
            self.expert_paths = self.expert_paths[-self.buffer_size:]
        if self.save_logs:
            self.logger.log_kv("buffer_size", len(self.expert_paths))

    def get_data_from_buffer(self):
        observations = np.concatenate(
            [p["observations"] for p in self.expert_paths])
        expert_actions = np.concatenate(
            [p["expert_actions"] for p in self.expert_paths])
        return dict(observations=observations,
                    expert_actions=expert_actions)

    def train_step(self, num_traj=10, **kwargs):
        new_paths = self.collect_paths(num_traj, mode="policy")
        self.add_paths_to_buffer(new_paths)
        data = self.get_data_from_buffer()
        self.fit(data, **kwargs)
        stoc_pol_perf = np.mean([np.sum(p["rewards"]) for p in new_paths])
        return stoc_pol_perf
