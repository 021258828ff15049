"""The benchmark of ``mjrl_tpu_torch``: whole NPG training iterations.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``.  The cell
``<name>`` names a configuration (``portbench/configs/<config>.json``, with
its frozen planar model ``<config>.planar.json`` and its task semantics
``portbench/envs/<reference_env>.py``) and a traffic mix
(``portbench/traffic/<traffic>.json``); its limits are
``portbench/limits/<name>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Nothing here names a cell.

A run builds the port's NPG agent (``mjrl_tpu_torch.algos.NPG`` with a
tanh MLP policy, the linear baseline and autoreset rollouts) with weights
made on the card from ``--seed``, drives it through its first iterations
through ``train_step`` (set-up: the kernel's load, the warm-up and the
iterations the reference follows), then measures whole iterations for
``--seconds`` seconds: the window closes at the end of the first iteration
that ends after them.  ``--trace 1`` then profiles one iteration after a
profiled warm-up iteration and reports the per-layer metrics.  Last, with
the program's state freed, the reference checks the set-up's iterations
(``reference/check.py``) and every compared number is printed beside its
limit, on standard error and in the result line.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with ``--trace 1``), and checks.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mjrl_tpu")
# batch leaves the reference reads
CAPTURED = ("observations", "actions", "rewards", "dones", "last_obs",
            "agent_mean")


def process_age_s():
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def fail(msg, code=2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by name."""

    def __init__(self, bench_path, workload):
        with open(bench_path) as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            fail(f"no workload {workload!r} in {bench_path}")
        self.name = workload
        w = cells[workload]
        self.chips = int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        self.cfg = load_json("configs", self.config_name + ".json")
        self.traffic = load_json("traffic", self.traffic_name + ".json")
        path = os.path.join(HERE, "limits", workload + ".json")
        self.limits = {}
        if os.path.exists(path):
            with open(path) as f:
                self.limits = json.load(f)["limits"]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.rows = int(self.traffic["rows"])
        self.horizon = int(self.cfg["horizon"])


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


# -- the program -------------------------------------------------------------

def build_agent(cell, seed, device, mesh=None):
    """The port's NPG agent for the cell (its batch split over ``mesh``'s
    ranks where given), its policy weights drawn on the device from
    ``seed`` in one call."""
    import torch
    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.baselines import LinearBaseline
    from mjrl_tpu_torch.envs import GymEnv
    from mjrl_tpu_torch.models.policies import MLP

    cfg = cell.cfg
    dtype = getattr(torch, cell.traffic.get("dtype", cfg["dtype"]))
    env = GymEnv(cfg["env"], device=device, env_kwargs={"dtype": dtype})
    policy = MLP(env.spec, hidden_sizes=tuple(cfg["policy_size"]),
                 min_log_std=cfg["min_log_std"],
                 init_log_std=cfg["init_log_std"], seed=seed, dtype=dtype,
                 device=device)
    policy.params = make_weights(policy.params, cfg, seed, device)
    policy.old_params = {k: v.clone() for k, v in policy.params.items()}
    baseline = LinearBaseline(env.spec, reg_coeff=cfg["baseline_reg_coeff"],
                              dtype=dtype, device=device)
    agent = NPG(env, policy, baseline,
                normalized_step_size=cfg["rl_step_size"],
                FIM_invert_args=dict(cfg["FIM_invert_args"]),
                kl_guard=cfg["kl_guard"], seed=seed, save_logs=True,
                device=device, mesh=mesh, **cfg["alg_hyper_params"])
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on; the configuration computes in float32")
    return agent


def make_weights(like, cfg, seed, device):
    """nn.Linear's init, U(-k, k) with k = 1/sqrt(fan_in), the last layer
    scaled by 1e-2, log_std at init_log_std: one draw on the device."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    net = [k for k in like if k != "log_std"]
    total = sum(like[k].numel() for k in net)
    u = torch.rand(total, generator=gen, device=device,
                   dtype=like["log_std"].dtype) * 2.0 - 1.0
    n_layers = sum(1 for k in net if k.endswith(".weight"))
    out, i = {}, 0
    for k in net:
        layer = int(k.split(".")[1])
        w = like[f"layers.{layer}.weight"]
        scale = (1e-2 if layer == n_layers - 1 else 1.0) / w.shape[1] ** 0.5
        n = like[k].numel()
        out[k] = (u[i:i + n] * scale).reshape(like[k].shape).to(
            like[k].dtype)
        i += n
    out["log_std"] = torch.full_like(like["log_std"], cfg["init_log_std"])
    return out


def train(agent, cell):
    cfg = cell.cfg
    return agent.train_step(cell.rows, sample_mode="trajectories",
                            horizon=cell.horizon, gamma=cfg["rl_gamma"],
                            gae_lambda=cfg["rl_gae"])


def cpu_copy(tree):
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def guard_backtracks(stats):
    """How often the program's KL guard scaled its step by 0.7: its step
    size against sqrt(|delta / g.x|) of its own gradient g and direction
    x."""
    import math
    g, x = stats["vpg_grad"], stats["npg_grad"]
    gx = float(sum((g[k].double() * x[k].double()).sum() for k in g))
    alpha0 = math.sqrt(abs(float(stats["delta"]) / (gx + 1e-20)))
    return round(math.log(float(stats["alpha"]) / alpha0) / math.log(0.7))


def checked_iterations(agent, cell):
    """The set-up's iterations the reference follows, each through
    ``train_step``; the batch each trained on is copied to the host as it
    passes ``_train_from_batch``."""
    batches, grads = [], []
    original = agent._train_from_batch
    update = agent._update_core

    def recording(batch, *args, **kwargs):
        batches.append({k: batch[k].detach().cpu() for k in CAPTURED})
        return original(batch, *args, **kwargs)

    def gradient(*args, **kwargs):
        new, stats = update(*args, **kwargs)
        grads.append(cpu_copy(stats["vpg_grad"]))
        run["backtracks"].append(guard_backtracks(stats))
        return new, stats

    run = dict(theta1=cpu_copy(agent.policy.params),
               beta1=agent.baseline.state.detach().cpu().clone(),
               steps=[], thetas=[], betas=[], surrs=[], backtracks=[],
               check_rows=int(cell.traffic["check_rows"]))
    agent._train_from_batch = recording
    agent._update_core = gradient
    try:
        for _ in range(int(cell.traffic["checked_iterations"])):
            theta = cpu_copy(agent.policy.params)
            train(agent, cell)
            run["steps"].append(dict(batch=batches.pop(), theta=theta,
                                     grad=grads.pop()))
            run["thetas"].append(cpu_copy(agent.policy.params))
            run["betas"].append(agent.baseline.state.detach().cpu().clone())
            run["surrs"].append(float(
                agent.logger.log["surr_improvement"][-1]))
    finally:
        del agent._train_from_batch, agent._update_core
    sync(agent.device.type)
    return run


def window(agent, cell, seconds, ranks):
    """Whole iterations until ``seconds`` have passed on rank 0's clock ->
    (iterations, seconds, the agent log's entries of them)."""
    import torch
    first = len(agent.logger.log["time_sampling"])
    sync(agent.device.type)
    t0 = time.perf_counter()
    n = 0
    while True:
        train(agent, cell)          # ends in a synchronize
        n += 1
        over = float(time.perf_counter() - t0 >= seconds)
        if ranks.group:             # every rank stops after the same one
            over = float(ranks.sum(torch.tensor(
                [over if ranks.rank == 0 else 0.0],
                device=agent.device))[0])
        if over:
            break
    elapsed = time.perf_counter() - t0
    log = {k: list(v[first:]) for k, v in agent.logger.log.items()
           if isinstance(v, list) and len(v) >= first + n}
    return n, elapsed, log


# -- the traced iterations ---------------------------------------------------

def traced(agent, cell):
    """One warm-up and one measured iteration under torch.profiler, each
    phase of train_step in a span -> the profiler's raw events and the
    measured iteration's span."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    original = agent._get_phases

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with record_function("portbench." + name):
                return fn(*args, **kwargs)
        return wrapped

    def spanned(*args, **kwargs):
        roll, proc, upd, fit = original(*args, **kwargs)
        return (span("rollout", roll), span("update", proc),
                span("update", upd), span("fit", fit))

    agent._get_phases = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                with record_function(f"portbench.iteration{i}"):
                    train(agent, cell)
    finally:
        del agent._get_phases
    return list(prof.profiler.kineto_results.events())


def metric_readers(cell):
    readers = {}
    for m in cell.per_layer:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        readers[m["name"]] = (load_module(path, "portbench_metric_"
                                          + m["name"].replace(".", "_")), m)
    return readers


# -- the ranks of a cell on several cards ------------------------------------

def join_ranks(module, argv, args, world, device, overrides):
    """Rank 0 (this process, started with the cell's command) starts ranks
    1 .. world - 1 as processes of ``module`` with the same arguments, and
    every rank joins one process group (NCCL on the cards, gloo on the
    CPU) -> (the rank's ``Ranks``, the child processes, the mesh)."""
    import socket
    import torch  # noqa: F401  (before the group binds the card)
    from mjrl_tpu_torch.parallel.distributed import global_mesh, initialize
    from portbench.reference.npg import Ranks
    children = []
    if args.rank == 0:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            args.coordinator = f"localhost:{sock.getsockname()[1]}"
        extra = ["--device", device, "--coordinator", args.coordinator]
        if overrides:
            extra += ["--overrides", json.dumps(overrides)]
        children = [subprocess.Popen(
            [sys.executable, "-m", module] + list(argv) + extra
            + ["--rank", str(r)], stdout=subprocess.DEVNULL,
            cwd=os.path.dirname(HERE))
            for r in range(1, world)]
    cpu = device == "cpu"
    initialize(coordinator_address=args.coordinator, num_processes=world,
               process_id=args.rank, device="cpu" if cpu else None)
    mesh = global_mesh(device="cpu" if cpu else None)
    return Ranks(group=True, rank=args.rank), children, mesh


def wait_children(children):
    """Waits for the other ranks -> whether every one ended well."""
    ok = True
    for p in children:
        try:
            ok = p.wait(timeout=600) == 0 and ok
        except subprocess.TimeoutExpired:
            ok = False
    return ok


def stop_children(children):
    for p in children:
        if p.poll() is None:
            p.kill()
        p.wait()


def leave_group():
    """Every rank leaves the process group together (a rank that waits
    for its peers' exit inside the group would wait for ever)."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def add_rank_args(ap):
    """The arguments rank 0 hands to the other ranks (and tests to a run
    on the CPU)."""
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--overrides", default=None, help=argparse.SUPPRESS)


def setup_cell(args, device, overrides):
    """The cell with a test's toy overrides, and a check that the card(s)
    are there."""
    device = args.device or device
    if args.overrides:
        overrides = json.loads(args.overrides)
    cell = Cell(args.bench, args.workload)
    if overrides:                     # tests: a toy size on the CPU
        cell.traffic.update(overrides)
        cell.rows = int(cell.traffic["rows"])
        cell.horizon = int(cell.traffic.get("horizon", cell.horizon))
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            fail("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{cell.name} needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cell, device, overrides


# -- one run -----------------------------------------------------------------

def main(argv=None, device="cuda", overrides=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--bench", default="BENCHMARK.json",
                    help="the benchmark's description (default: the one "
                         "at the root of the checkout)")
    add_rank_args(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    cell, device, overrides = setup_cell(args, device, overrides)
    world = int(cell.traffic.get("ranks", 1))
    children = []
    try:
        if world > 1:
            ranks, children, mesh = join_ranks("portbench.run", argv, args,
                                               world, device, overrides)
        else:
            from portbench.reference.npg import ONE as ranks
            mesh = None
        return run_cell(cell, args, device, ranks, mesh, children)
    finally:
        stop_children(children)


def run_cell(cell, args, device, ranks, mesh, children):
    import torch
    from portbench.counts import load_config
    from portbench.reference import check
    from portbench import trace as trace_mod

    _, planar = load_config(cell.config_name)
    readers = metric_readers(cell) if args.trace else {}

    # set-up: the program, its kernel's load and the checked iterations
    agent = build_agent(cell, args.seed, device, mesh)
    run = checked_iterations(agent, cell)
    setup_s = process_age_s()

    # the measured window
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls0 = mesh.collectives if mesh is not None else 0
    iters, elapsed, log = window(agent, cell, args.seconds, ranks)
    calls = (mesh.collectives - calls0) if mesh is not None else 0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    peak = int(ranks.max(torch.tensor([float(peak)],
                                      device=agent.device))[0])
    samples = iters * cell.rows * cell.horizon
    failed = sum(1 for s, m in zip(log.get("num_samples", []),
                                   log.get("stoc_pol_mean", []))
                 if s != cell.rows * cell.horizon or m != m)
    events = traced(agent, cell) if args.trace else None
    sync(device)
    found = sorted({name.split(".")[0] for name in sys.modules}
                   & set(FORBIDDEN))
    if found:
        fail(f"the process holds {', '.join(found)} after the window", 3)

    # the check, with the program's state freed
    dev = agent.device
    del agent
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, _, checked = check.program_numbers(run, cell.cfg, planar,
                                                dev, args.seed, ranks)
    t_check = time.perf_counter() - t_check
    tr = trace_mod.read(events) if args.trace else None
    if tr is not None and ranks.group:      # the card's busy time, averaged
        tr["busy_s"] = float(ranks.sum(torch.tensor(
            [tr["busy_s"]], dtype=torch.float64, device=dev))[0]) \
            / mesh.size
    leave_group()
    if ranks.rank != 0:
        return 0
    if not wait_children(children):
        fail("a rank of the cell failed")

    # every number has an entry in the cell's limits; null where PERF.md
    # shows that no limit separates the program's readings from a fault's
    checks = {}
    correct = checked > 0
    for name in check.COMPARED:
        value, limit = numbers[name], cell.limits.get(name, "missing")
        if limit is not None:
            correct = correct and limit != "missing" and value <= limit
        checks[name] = {"value": value, "limit": limit}

    result = {"correct": bool(correct), "attempted": iters,
              "failed": failed}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0)
                   if device == "cuda" else device,
                   "count": cell.chips, "memory_peak_bytes": peak}
    if args.trace:
        ctx = dict(cell=cell, cfg=cell.cfg, counts=cell.cfg["counts"],
                   log=log, iterations=iters, seconds=elapsed,
                   samples=samples, trace=tr, peak_bytes=peak,
                   rows=cell.rows // (mesh.size if mesh else 1),
                   rows_total=cell.rows, horizon=cell.horizon,
                   collectives=calls, ranks=mesh.size if mesh else 1)
        metrics = {}
        for name, (mod, spec) in readers.items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": spec["unit"]}
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    else:
        result["metrics"] = {
            "samples_per_s": {"value": samples / elapsed,
                              "unit": "samples/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = device_info
    result["card"] = power_limit() if device == "cuda" else None
    result["phase_s"] = {k: log[k] for k in ("time_sampling", "time_npg",
                                             "time_VF")}
    result["transitions_checked"] = checked
    result["check_s"] = t_check
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
