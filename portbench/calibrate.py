"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 3] [--witness]

For each seed, in one process: the program's set-up as a run makes it (the
agent from the seed and its checked iterations through ``train_step``),
then, with the program freed, the float64 reference and

- ``program``: the program's numbers (the lower readings);

- ``float32`` (on every seed with ``--witness``): a witness, the reference
  itself in float32 without TF32 in the program's place, its chain of
  updates and fits and the frozen plain step in float32;

and on the first ``--control-seeds`` seeds, besides the witness:

- ``control``: the reference in the program's place at the precision below
  the configuration's (float32 with TF32 matrix products): its chain of
  updates and fits on the same batches, its policy means, and the frozen
  plain step in float32 on the same transitions;
- ``half_batch``: the reference in the program's place on half of each
  batch's rows, every mean taken over the rest;
- ``altered_state``: the next observations the program produced with one
  coordinate (the last joint's velocity) altered by 0.01;
- ``altered_noise``: the taken actions' noise scaled by 0.99;
- ``no_exchange`` (a cell on several cards): each rank's reference steps
  on its own rows alone, the exchange between the cards left out;
- ``unchanged``: iterations that return the training state unchanged:
  the policy, the baseline, a surrogate improvement of 0.

One JSON line per seed and reading.
"""

import argparse
import json
import sys

import torch

from portbench import run as bench
from portbench.counts import load_config
from portbench.reference import check, npg


def readings(cell, seed, device, with_faults, mesh=None, ranks=npg.ONE,
             witness=False):
    """The readings of one seed (the float32 witness with ``witness`` or
    ``with_faults``); under ``mesh`` each rank holds its rows and the
    reference reduces over ``ranks``."""
    agent = bench.build_agent(cell, seed, device, mesh)
    dev = agent.device
    prog = bench.checked_iterations(agent, cell)
    del agent
    if device == "cuda":
        torch.cuda.empty_cache()
    _, p = load_config(cell.config_name)
    cfg = cell.cfg
    out = {}
    numbers, ref, _ = check.program_numbers(prog, cfg, p, dev, seed, ranks)
    out["program"] = dict(numbers, backtracks=prog["backtracks"])
    if not (with_faults or witness):
        return out
    steps, theta1, beta1 = prog["steps"], prog["theta1"], prog["beta1"]
    env = check.load_env(cfg["reference_env"])
    n_rows = steps[0]["batch"]["rewards"].shape[0]
    rows = check.check_rows(n_rows, prog["check_rows"], seed + ranks.rank)

    def chain_numbers(chain, over=ranks):
        out = check.update_numbers(
            chain[0]["grad"], [c["theta"] for c in chain],
            [c["beta"] for c in chain],
            [c["surr_improvement"] for c in chain], ref, steps, theta1,
            dev, over)
        out["backtracks"] = [c["backtracks"] for c in chain]
        return out

    # a witness: the reference itself in float32 (no TF32), in the
    # program's place
    f32 = chain_numbers(check.follow(steps, theta1, beta1, cfg,
                                     npg.Arith(float32=True), dev,
                                     ranks=ranks))
    f32.update(check.physics_numbers(steps, cfg, env, p, rows, dev,
                                     dtype=torch.float32, ranks=ranks)[0])
    out["float32"] = f32
    if not with_faults:
        return out
    ar = npg.Arith(tf32=True)
    ctl = chain_numbers(check.follow(steps, theta1, beta1, cfg, ar, dev,
                                     ranks=ranks))
    ctl.update(check.policy_numbers(steps, rows, dev, ar=ar, ranks=ranks))
    out["control"] = ctl
    half = torch.arange(n_rows // 2)
    out["half_batch"] = chain_numbers(check.follow(
        steps, theta1, beta1, cfg, npg.Arith(), dev, rows=half,
        ranks=ranks))
    if ranks.group:
        # the exchange between the cards left out: each rank steps on its
        # own rows alone
        out["no_exchange"] = chain_numbers(check.follow(
            steps, theta1, beta1, cfg, npg.Arith(), dev))

    def alter(o):
        o = o.clone()
        o[:, -1] += 0.01
        return o
    out["altered_state"] = check.physics_numbers(
        steps, cfg, env, p, rows, dev, alter=alter, ranks=ranks)[0]
    noisy = []
    for st in steps:
        b = dict(st["batch"])
        b["actions"] = b["agent_mean"] + 0.99 * (b["actions"]
                                                 - b["agent_mean"])
        noisy.append(dict(st, batch=b))
    out["altered_noise"] = check.policy_numbers(noisy, rows, dev,
                                                ranks=ranks)
    k = len(steps)
    out["unchanged"] = check.update_numbers(
        steps[0]["grad"], [theta1] * k, [beta1] * k, [0.0] * k, ref, steps,
        theta1, dev, ranks)
    return out


def main(argv=None, device="cuda", overrides=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--witness", action="store_true",
                    help="the float32 witness on every seed")
    ap.add_argument("--bench", default="BENCHMARK.json")
    bench.add_rank_args(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    cell, device, overrides = bench.setup_cell(args, device, overrides)
    world = int(cell.traffic.get("ranks", 1))
    children, mesh, ranks = [], None, npg.ONE
    try:
        if world > 1:
            ranks, children, mesh = bench.join_ranks(
                "portbench.calibrate", argv, args, world, device, overrides)
        if args.rank == 0:
            print(json.dumps({"card": bench.power_limit()}), flush=True)
        for i, seed in enumerate(args.seeds):
            out = readings(cell, seed, device, i < args.control_seeds, mesh,
                           ranks, args.witness)
            for kind, numbers in out.items():
                if args.rank == 0:
                    print(json.dumps({"workload": cell.name, "seed": seed,
                                      "reading": kind, **numbers}),
                          flush=True)
        bench.leave_group()
        if args.rank == 0 and not bench.wait_children(children):
            bench.fail("a rank failed")
        return 0
    finally:
        bench.stop_children(children)


if __name__ == "__main__":
    sys.exit(main())
