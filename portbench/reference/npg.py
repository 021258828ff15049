"""The plain reference of one NPG iteration on an autoreset grid, in plain
PyTorch: returns and GAE with episode ends, advantage whitening, the
Gaussian MLP policy, the policy gradient, the Fisher-vector product in
closed form (the Gauss-Newton form of the mean KL's Hessian, which equals
it at the old parameters), ten CG iterations from x0 = g, the normalized
step with its KL guard, the min_log_std clamp, and the linear baseline's
regularized least squares.  It imports nothing of the program.

It runs in float64 (the reference) or in float32 with every matrix
product's operands rounded to TF32's 10-bit mantissa, as the tensor cores
take them, in the forward and the backward pass (the control: the
precision below the configuration's float32 without TF32).

A batch is a dict of tensors on the host or the card: observations (N, T,
O), actions (N, T, A), rewards (N, T), dones (N, T), last_obs (N, O).
Parameters are the port's dict layout: ``layers.<i>.weight`` (out, in),
``layers.<i>.bias``, ``log_std``.
"""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
BLOCK = 1 << 21          # samples per block of the policy's passes


def tf32_round(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


class Arith:
    """The precision a reference computes in: float64, or float32 with
    TF32 matrix products (``tf32=True``)."""

    def __init__(self, tf32=False, float32=False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 or float32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            return _TF32Matmul.apply(a, b)
        return a @ b


class Ranks:
    """Sums and maxima over the ranks of a process group, for a reference
    whose batch is split over ranks (``torch.distributed.all_reduce``);
    one process: identities."""

    def __init__(self, group=False, rank=0):
        self.group, self.rank = group, rank

    def sum(self, t):
        if self.group:
            import torch.distributed as tdist
            tdist.all_reduce(t)
        return t

    def max(self, t):
        if self.group:
            import torch.distributed as tdist
            tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
        return t


ONE = Ranks()


def n_layers(theta):
    return sum(1 for k in theta if k.endswith(".weight"))


def policy_mean(theta, x, ar):
    """The tanh MLP's mean, x (M, O) -> (M, A)."""
    n = n_layers(theta)
    h = x
    for i in range(n):
        h = ar.mm(h, theta[f"layers.{i}.weight"].T) + theta[f"layers.{i}.bias"]
        if i < n - 1:
            h = torch.tanh(h)
    return h


def policy_mean_tangent(theta, v, x, ar):
    """The mean's directional derivative along ``v`` (a dict like
    ``theta``), by forward propagation of tangents."""
    n = n_layers(theta)
    h, dh = x, None
    for i in range(n):
        w, b = theta[f"layers.{i}.weight"], theta[f"layers.{i}.bias"]
        z = ar.mm(h, w.T) + b
        dz = ar.mm(h, v[f"layers.{i}.weight"].T) + v[f"layers.{i}.bias"]
        if dh is not None:
            dz = dz + ar.mm(dh, w.T)
        if i < n - 1:
            h = torch.tanh(z)
            dh = (1.0 - h * h) * dz
        else:
            dh = dz
    return dh


def log_likelihood(mu, log_std, act):
    z = (act - mu) / torch.exp(log_std)
    return -0.5 * (z * z).sum(-1) - log_std.sum() \
        - 0.5 * act.shape[-1] * LOG_2PI


def kl_terms(mu_o, ls_o, mu_n, ls_n):
    """Per-sample KL(old || new) of two diagonal Gaussians, as mjrl writes
    it (the 1e-8 in the denominator included)."""
    so, sn = torch.exp(ls_o), torch.exp(ls_n)
    nr = (mu_o - mu_n) ** 2 + so ** 2 - sn ** 2
    return (nr / (2.0 * sn ** 2 + 1e-8) + ls_n - ls_o).sum(-1)


# -- returns, GAE, whitening -------------------------------------------------

def returns_with_dones(rew, dones, gamma):
    out = torch.empty_like(rew)
    carry = torch.zeros_like(rew[:, 0])
    for t in range(rew.shape[1] - 1, -1, -1):
        carry = rew[:, t] + gamma * carry * (1.0 - dones[:, t])
        out[:, t] = carry
    return out


def gae_with_dones(rew, values, dones, v_last, gamma, lam):
    v_next = torch.cat([values[:, 1:], v_last[:, None]], dim=1)
    deltas = rew + gamma * v_next * (1.0 - dones) - values
    out = torch.empty_like(rew)
    carry = torch.zeros_like(rew[:, 0])
    for t in range(rew.shape[1] - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * (1.0 - dones[:, t]) * carry
        out[:, t] = carry
    return out


def whiten(x, ranks=ONE):
    n = ranks.sum(torch.tensor(float(x.numel()), dtype=x.dtype,
                               device=x.device))
    mean = ranks.sum(x.sum()) / n
    std = torch.sqrt(ranks.sum(((x - mean) ** 2).sum()) / n)
    return (x - mean) / (std + 1e-6)


# -- the linear baseline -----------------------------------------------------

def baseline_features(obs):
    """(N, T, O) -> (N, T, O + 5): [clip(o, +-10) / 10, 1, (t/1000)^1..4]
    with t the column of the grid."""
    N, T, _ = obs.shape
    t = torch.arange(T, dtype=obs.dtype, device=obs.device) / 1000.0
    tf = torch.stack([t, t ** 2, t ** 3, t ** 4], dim=-1).expand(N, T, 4)
    ones = torch.ones((N, T, 1), dtype=obs.dtype, device=obs.device)
    return torch.cat([obs.clamp(-10.0, 10.0) / 10.0, ones, tf], dim=-1)


def baseline_predict(beta, obs, ar):
    f = baseline_features(obs)
    return ar.mm(f.reshape(-1, f.shape[-1]), beta[:, None]).reshape(
        f.shape[:2])


def baseline_fit(beta, obs, returns, reg, ar, ranks=ONE):
    """-> (new coefficients, relative error before, after)."""
    f = baseline_features(obs).reshape(-1, obs.shape[-1] + 5)
    r = returns.reshape(-1)
    ftf = ranks.sum(ar.mm(f.T, f))
    ftr = ranks.sum(ar.mm(f.T, r[:, None])[:, 0])
    eye = torch.eye(f.shape[1], dtype=f.dtype, device=f.device)
    new = beta
    for k in range(10):
        c = torch.linalg.solve(ftf + reg * (10.0 ** k) * eye, ftr)
        if torch.isfinite(c).all():
            new = c
            break
    den = ranks.sum((r * r).sum())

    def err(b):
        e = r - ar.mm(f, b[:, None])[:, 0]
        return ranks.sum((e * e).sum()) / den
    return new, err(beta), err(new)


# -- the NPG step ------------------------------------------------------------

def _flat(d, keys):
    return torch.cat([d[k].reshape(-1) for k in keys])


def _unflat(x, like, keys):
    out, i = {}, 0
    for k in keys:
        n = like[k].numel()
        out[k] = x[i:i + n].reshape(like[k].shape)
        i += n
    return out


class _Samples:
    """Flat samples of a batch in blocks, cast to the arithmetic's type on
    the device."""

    def __init__(self, obs, act, adv, ar, device):
        self.obs = obs.reshape(-1, obs.shape[-1])
        self.act = act.reshape(-1, act.shape[-1])
        self.adv = adv.reshape(-1)
        self.n = self.obs.shape[0]
        self.ar, self.device = ar, device

    def blocks(self):
        for lo in range(0, self.n, BLOCK):
            hi = min(lo + BLOCK, self.n)
            cast = lambda x: x[lo:hi].to(self.device, self.ar.dtype)
            yield cast(self.obs), cast(self.act), cast(self.adv)


def npg_step(theta, smp, cfg, ar, ranks=ONE):
    """One NPG update of ``theta`` on the samples (of every rank's rows:
    each sum over samples is summed over ``ranks``) -> (new theta, the
    gradient, the surrogate's improvement, the KL guard's backtracks)."""
    keys = list(theta)
    net = [k for k in keys if k != "log_std"]
    ls = theta["log_std"]
    n = float(ranks.sum(torch.tensor(float(smp.n), dtype=torch.float64,
                                     device=ls.device)))
    damping = cfg["FIM_invert_args"]["damping"]
    iters = cfg["FIM_invert_args"]["iters"]
    delta = cfg["rl_step_size"]

    # the gradient of mean(ratio * adv) at the old parameters
    grads = {k: torch.zeros_like(v) for k, v in theta.items()}
    for obs, act, adv in smp.blocks():
        p = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
        ll = log_likelihood(policy_mean(p, obs, ar), p["log_std"], act)
        g = torch.autograd.grad((ll * adv).sum() / n, list(p.values()))
        for k, gk in zip(p, g):
            grads[k] += gk
    g = ranks.sum(_flat(grads, keys))
    grads = _unflat(g, theta, keys)

    inv_var = torch.exp(-2.0 * ls)

    def fvp(v):
        vd = _unflat(v, theta, keys)
        out = {k: torch.zeros_like(x) for k, x in theta.items()}
        for obs, _, _ in smp.blocks():
            with torch.no_grad():
                dmu = policy_mean_tangent(theta, vd, obs, ar)
            p = {k: theta[k].detach().requires_grad_(True) for k in net}
            mu = policy_mean({**p, "log_std": ls}, obs, ar)
            jt = torch.autograd.grad(mu, list(p.values()),
                                     grad_outputs=dmu * inv_var / n)
            for k, x in zip(p, jt):
                out[k] += x
        out = _unflat(ranks.sum(_flat(out, keys)), theta, keys)
        out["log_std"] = 2.0 * vd["log_std"]
        return _flat(out, keys) + damping * v

    # CG from x0 = g, ten iterations, frozen below a squared residual 1e-10
    x = g.clone()
    r = g - fvp(x)
    d = r.clone()
    rdotr = r @ r
    done = bool(rdotr < 1e-10)
    for _ in range(iters):
        if done:
            break
        z = fvp(d)
        pz = d @ z
        if pz == 0:
            break
        v = rdotr / pz
        x = x + v * d
        r = r - v * z
        new = r @ r
        mu = new / rdotr if rdotr != 0 else torch.zeros_like(new)
        d = r + mu * d
        rdotr = new
        done = bool(new < 1e-10)

    alpha = torch.sqrt(torch.abs(delta / (g @ x + 1e-20)))
    step = _unflat(x, theta, keys)

    def stepped(a):
        new = {k: theta[k] + a * step[k] for k in keys}
        new["log_std"] = torch.clamp(new["log_std"], min=cfg["min_log_std"])
        return new

    def kl_and_surr(new):
        kl = surr = 0.0
        for obs, act, adv in smp.blocks():
            with torch.no_grad():
                mu_o = policy_mean(theta, obs, ar)
                mu_n = policy_mean(new, obs, ar)
                kl = kl + kl_terms(mu_o, ls, mu_n, new["log_std"]).sum()
                lr = torch.exp(log_likelihood(mu_n, new["log_std"], act)
                               - log_likelihood(mu_o, ls, act))
                surr = surr + (lr * adv).sum()
        both = ranks.sum(torch.stack([kl, surr]))
        return both[0] / n, both[1] / n

    backtracks = 0
    if cfg.get("kl_guard"):
        cap = cfg["kl_guard"] * 0.5 * delta
        for _ in range(10):
            if not bool(kl_and_surr(stepped(alpha))[0] > cap):
                break
            alpha = 0.7 * alpha
            backtracks += 1
    new = stepped(alpha)
    _, surr_after = kl_and_surr(new)
    surr_before = ranks.sum(torch.cat([a for _, _, a in smp.blocks()])
                            .sum()) / n
    return new, grads, surr_after - surr_before, backtracks


def iteration(theta, beta, batch, cfg, ar, device, rows=None,
              ranks=ONE):
    """One NPG iteration of the reference on ``batch`` (the rows ``rows``
    of it, all by default; under ``ranks``, this rank's rows of a batch
    split over ranks) from policy ``theta`` and baseline ``beta`` ->
    dict(theta, beta, grad, surr_improvement, vf_error_before,
    vf_error_after, returns, backtracks)."""
    sel = slice(None) if rows is None else rows
    cast = lambda x: x[sel].to(device, ar.dtype)
    obs, act = cast(batch["observations"]), cast(batch["actions"])
    rew, dones = cast(batch["rewards"]), cast(batch["dones"])
    last = cast(batch["last_obs"])
    gamma, lam = cfg["rl_gamma"], cfg["rl_gae"]
    beta = beta.to(device, ar.dtype)
    with torch.no_grad():
        returns = returns_with_dones(rew, dones, gamma)
        values = baseline_predict(beta, torch.cat([obs, last[:, None]], 1),
                                  ar)
        adv = whiten(gae_with_dones(rew, values[:, :-1], dones,
                                    values[:, -1], gamma, lam), ranks)
    theta = {k: v.to(device, ar.dtype) for k, v in theta.items()}
    new_theta, grad, surr, backtracks = npg_step(
        theta, _Samples(obs, act, adv, ar, device), cfg, ar, ranks)
    with torch.no_grad():
        new_beta, e0, e1 = baseline_fit(beta, obs, returns,
                                        cfg["baseline_reg_coeff"], ar,
                                        ranks)
    return dict(theta={k: v.detach() for k, v in new_theta.items()},
                beta=new_beta, grad=grad, surr_improvement=float(surr),
                vf_error_before=float(e0), vf_error_after=float(e1),
                returns=returns, backtracks=backtracks)
