"""The port's spans (``mjrl_tpu_torch.utils.profiling``) on
the CPU, at a toy size: NPG with autoreset on the Swimmer (K1's plain
step) and on Hopper-v3 (K2's), 8 rows.

- tracing off: ``span`` is one shared no-op and a ``train_step`` records
  nothing;
- tracing on: the span tree of an iteration, its counts (``control_step``
  T times, ``fvp`` CG's iterations + 1, ``reset`` once a control step on
  Hopper), the ``train_step`` id every span carries, the control step's
  spans host-timed alone, children inside their parents, each ``mjrl.*``
  profiler event at the recorder's start for it, ``spans.json`` beside
  ``trace.json``, and the recorder's bound;
- on a card (stand-in events here) a timed span's ``device_s`` comes from
  its two timing events, which it gives up once read; an untimed span and
  a tree whose root names no CUDA device make no event;
- a torch build without the profiler's fast range falls back to
  ``record_function``;
- the profiler leaves an iteration's parameters bitwise unchanged;
- under a one-rank gloo group every ``Mesh.all_reduce_sum`` is one
  ``collective`` span.

This file imports no JAX.
"""

import datetime
import json
import time

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.baselines import LinearBaseline
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.parallel.mesh import make_mesh
from mjrl_tpu_torch.utils import profiling

ROWS, CG_ITERS = 8, 10
UNTIMED = ("control_step", "policy", "env_step")
PARENT = {"rollout": "train_step", "control_step": "rollout",
          "policy": "control_step", "env_step": "control_step",
          "reset": "control_step", "gae": "train_step",
          "update": "train_step", "vpg_grad": "update", "cg": "update",
          "fvp": "cg", "line_search": "update", "fit": "train_step"}


def agent(env_id, mesh=None):
    env = GymEnv(env_id, device="cpu")
    policy = MLP(env.spec, hidden_sizes=(8, 8), seed=1, device="cpu")
    return NPG(env, policy, LinearBaseline(env.spec, device="cpu"),
               normalized_step_size=0.05, seed=1, device="cpu",
               FIM_invert_args={"iters": CG_ITERS, "damping": 1e-4},
               autoreset=True, mesh=mesh)


def iteration(a, horizon):
    a.train_step(ROWS, horizon=horizon, gamma=0.995, gae_lambda=0.97)


def profiled(fn):
    """fn() under torch.profiler -> its raw events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def swimmer(tmp_path_factory):
    """One Swimmer iteration untraced and its twin under
    ``profiling.trace``: (the twins' parameters, what the untraced one
    recorded, the traced one's spans, the trace's directory)."""
    torch.set_num_threads(1)
    horizon = 2
    untraced, traced = agent("mjrl_swimmer-v0"), agent("mjrl_swimmer-v0")
    profiling.clear()
    iteration(untraced, horizon)
    recorded_off = profiling.trees()
    out = tmp_path_factory.mktemp("trace")
    with profiling.trace(str(out)):
        iteration(traced, horizon)
    return dict(horizon=horizon, params=(untraced.policy.params,
                                         traced.policy.params),
                recorded_off=recorded_off, tree=profiling.trees()[-1],
                table=profiling.last_step(), dir=out)


@pytest.fixture(scope="module")
def hopper():
    """One Hopper-v3 iteration under the profiler: (its spans, the
    profiler's events)."""
    torch.set_num_threads(1)
    horizon = 2
    a = agent("Hopper-v3")
    profiling.clear()
    events = profiled(lambda: iteration(a, horizon))
    return dict(horizon=horizon, tree=profiling.trees()[-1],
                table=profiling.last_step(), events=events)


def test_tracing_off_is_one_shared_no_op(swimmer):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a", device="cpu", timed=False):
        pass
    assert swimmer["recorded_off"] == []


def test_profiler_leaves_parameters_bitwise_equal(swimmer):
    off, on = swimmer["params"]
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("cell", ["swimmer", "hopper"])
def test_span_tree_of_an_iteration(cell, request):
    run = request.getfixturevalue(cell)
    tree, table, horizon = run["tree"], run["table"], run["horizon"]
    root = tree[-1]
    assert root.name == "train_step" and root.parent is None
    by_id = {s.id: s for s in tree}
    for s in tree:
        assert s.step == root.id
        if s is not root:
            assert by_id[s.parent].name == PARENT[s.name], s.name
    expected = set(PARENT) | {"train_step"}
    if cell == "swimmer":               # the Swimmer never terminates
        expected.discard("reset")
    assert set(table) == expected
    assert table["control_step"]["count"] == horizon
    assert table["fvp"]["count"] == CG_ITERS + 1
    for name in ("rollout", "gae", "update", "cg", "fit", "line_search",
                 "vpg_grad"):
        assert table[name]["count"] == 1, name
    if cell == "hopper":
        assert table["reset"]["count"] == horizon
    for name, row in table.items():
        assert row["host_s"] > 0, name
        if name in UNTIMED:
            assert row["device_s"] is row["self_device_s"] is None, name
        else:
            assert row["device_s"] > 0, name


@pytest.mark.parametrize("cell", ["swimmer", "hopper"])
def test_children_inside_their_parents(cell, request):
    tree = request.getfixturevalue(cell)["tree"]
    by_id = {s.id: s for s in tree}
    below = {}              # each timed span's nearest timed spans below
    for s in tree:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        top = profiling.timed_parent(s, by_id) if s.timed else None
        if top is not None:
            below.setdefault(top.id, []).append(s)
    tops = {"train_step", "update", "cg"}
    if cell == "hopper":                # the rollout's timed resets
        tops.add("rollout")
    assert {by_id[i].name for i in below} >= tops
    for pid, kids in below.items():
        assert sum(k.device_s for k in kids) <= by_id[pid].device_s + 1e-9
    for row in request.getfixturevalue(cell)["table"].values():
        if row["device_s"] is not None:
            assert 0.0 <= row["self_device_s"] <= row["device_s"] + 1e-9


def test_profiler_events_start_with_the_recorder(hopper):
    cpu = torch.autograd.DeviceType.CPU
    marks = sorted((e.start_ns(), e.name()) for e in hopper["events"]
                   if e.device_type() == cpu
                   and e.name().startswith(profiling.PREFIX))
    spans = sorted((s.start_ns, profiling.PREFIX + s.name)
                   for s in hopper["tree"])
    assert len(marks) == len(spans)
    for (t_event, name_event), (t_span, name_span) in zip(marks, spans):
        assert name_event == name_span
        assert abs(t_event - t_span) < 1_000_000


def test_spans_json_beside_the_trace(swimmer):
    with open(swimmer["dir"] / "spans.json") as f:
        written = json.load(f)
    assert (swimmer["dir"] / "trace.json").exists()
    assert [t["root"] for t in written] == ["train_step"]
    spans = written[0]["spans"]
    assert spans["fvp"]["count"] == CG_ITERS + 1
    assert spans["train_step"]["device_s"] == pytest.approx(
        swimmer["table"]["train_step"]["device_s"])


def test_recorder_keeps_the_last_roots():
    profiling.clear()

    def roots():
        for i in range(3 * profiling.KEEP):
            with profiling.span(f"root{i}"):
                with profiling.span("child"):
                    pass
    profiled(roots)
    kept = profiling.trees()
    assert len(kept) == profiling.KEEP
    assert kept[-1][-1].name == f"root{3 * profiling.KEEP - 1}"
    assert [s.name for s in kept[-1]] == ["child", kept[-1][-1].name]
    assert profiling.last_step() is None       # no train_step among them
    profiling.clear()
    assert profiling.trees() == []


class StandInEvent:
    """A CUDA timing event's interface on the host clock; it counts the
    events made and the waits."""
    made = waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        StandInEvent.made += 1
        self.ns = None

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def synchronize(self):
        StandInEvent.waits += 1

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


def test_card_spans_read_their_timing_events(monkeypatch):
    """The recorder's path on a card, with stand-in events: two events a
    timed span and none an untimed one, no wait while the spans run, each
    timed span's device_s from its events when read, and the events given
    up then."""
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    StandInEvent.made = StandInEvent.waits = 0
    profiling.clear()

    def root():
        with profiling.span("train_step", device="cuda"):
            for _ in range(3):
                with profiling.span("step", timed=False):
                    with profiling.span("child"):
                        time.sleep(1e-4)
    profiled(root)
    tree = profiling.trees()[-1]
    assert StandInEvent.made == 8 and StandInEvent.waits == 0
    kids = [s for s in tree if s.name == "child"]
    top = tree[-1]
    assert all(k.device_s >= 1e-4 for k in kids)
    assert sum(k.device_s for k in kids) <= top.device_s
    assert StandInEvent.waits == 4
    assert all(s._start is None and s._end is None for s in tree)
    table = profiling.last_step()
    assert table["child"]["count"] == table["step"]["count"] == 3
    assert table["step"]["device_s"] is None
    assert table["train_step"]["self_device_s"] == pytest.approx(
        top.device_s - sum(k.device_s for k in kids))
    profiling.clear()


def test_spans_off_the_card_make_no_events(monkeypatch):
    """A tree whose root names no CUDA device times on the host, even in a
    process that has initialised CUDA."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    StandInEvent.made = 0
    profiling.clear()

    def roots():
        for device in (None, "cpu"):
            with profiling.span("train_step", device=device):
                with profiling.span("child"):
                    time.sleep(1e-4)
    profiled(roots)
    assert StandInEvent.made == 0
    for tree in profiling.trees():
        assert all(s.device_s == s.host_s for s in tree)
    profiling.clear()


def test_spans_fall_back_to_record_function(monkeypatch):
    """Without the profiler's fast range a span enters ``record_function``
    and still lands on the profiler's timeline."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    profiling.clear()

    def root():
        with profiling.span("train_step"):
            with profiling.span("child"):
                pass
    events = profiled(root)
    names = {e.name() for e in events}
    assert {"mjrl.train_step", "mjrl.child"} <= names
    assert profiling.last_step()["child"]["count"] == 1
    profiling.clear()


def test_collective_spans_count_the_mesh_collectives(tmp_path):
    """A one-rank gloo group issues its collectives: each is one span."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "group_init"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None
        a = agent("mjrl_swimmer-v0", mesh=mesh)
        profiling.clear()
        before = mesh.collectives
        profiled(lambda: iteration(a, 2))
        issued = mesh.collectives - before
    finally:
        dist.destroy_process_group()
    table = profiling.last_step()
    assert issued > CG_ITERS
    assert table["collective"]["count"] == issued
