"""Host-side sample processing for list-of-paths data (counterpart of
``mjrl_tpu/utils/process_samples.py``).

The training pipeline computes returns/GAE on batched tensors
(``mjrl_tpu_torch.ops.gae``); these helpers provide the mjrl in-place
path-dict API (numpy) for scripts.
"""

import numpy as np


def discount_sum(x, gamma, terminal=0.0):
    """Reverse discounted cumsum."""
    y = np.zeros_like(np.asarray(x, dtype=np.float64))
    run = terminal
    for t in range(len(x) - 1, -1, -1):
        run = x[t] + gamma * run
        y[t] = run
    return y


def compute_returns(paths, gamma):
    for path in paths:
        path["returns"] = discount_sum(path["rewards"], gamma)


def compute_advantages(paths, baseline, gamma, gae_lambda=None,
                       normalize=False):
    """Standard (A = R - V) or GAE(lambda) advantages with the bootstrap
    rule: terminated -> 0, else baseline[-1]."""
    if gae_lambda is None or gae_lambda < 0.0 or gae_lambda > 1.0:
        for path in paths:
            path["baseline"] = baseline.predict(path)
            path["advantages"] = path["returns"] - path["baseline"]
    else:
        for path in paths:
            b = path["baseline"] = np.asarray(baseline.predict(path))
            terminal = 0.0 if path.get("terminated", False) else b[-1]
            b1 = np.append(b, terminal)
            td_deltas = path["rewards"] + gamma * b1[1:] - b1[:-1]
            path["advantages"] = discount_sum(td_deltas, gamma * gae_lambda)
    if normalize:
        alladv = np.concatenate([p["advantages"] for p in paths])
        mean_adv, std_adv = alladv.mean(), alladv.std()
        for path in paths:
            path["advantages"] = (path["advantages"] - mean_adv) \
                / (std_adv + 1e-8)
