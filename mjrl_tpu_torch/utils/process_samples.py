"""Host-side sample processing for list-of-paths data (counterpart of
``mjrl_tpu/utils/process_samples.py``).

The training pipeline computes returns/GAE on batched tensors
(``mjrl_tpu_torch.ops.gae``); these helpers provide the mjrl in-place
path-dict API (numpy) for scripts, through the native path ops
(``mjrl_tpu_torch.native``, host C++).
"""

import numpy as np

from mjrl_tpu_torch import native


def discount_sum(x, gamma, terminal=0.0):
    """Reverse discounted cumsum."""
    if terminal == 0.0:
        return native.discount_sums([np.asarray(x, np.float64)], gamma)[0]
    y = np.zeros_like(np.asarray(x, dtype=np.float64))
    run = terminal
    for t in range(len(x) - 1, -1, -1):
        run = x[t] + gamma * run
        y[t] = run
    return y


def compute_returns(paths, gamma):
    rets = native.discount_sums(
        [np.asarray(p["rewards"], np.float64) for p in paths], gamma)
    for path, r in zip(paths, rets):
        path["returns"] = r


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
            path["baseline"] = np.asarray(baseline.predict(path))
        advs = native.gae_advantages(
            [np.asarray(p["rewards"], np.float64) for p in paths],
            [np.asarray(p["baseline"], np.float64) for p in paths],
            [bool(p.get("terminated", False)) for p in paths],
            gamma, gae_lambda)
        for path, a in zip(paths, advs):
            path["advantages"] = a
    if normalize:
        alladv = np.concatenate([p["advantages"] for p in paths])
        mean_adv, std_adv = alladv.mean(), alladv.std()
        for path in paths:
            path["advantages"] = (path["advantages"] - mean_adv) \
                / (std_adv + 1e-8)
