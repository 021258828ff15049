"""The port's learning CLIs, ``tools/torch_train_gym.py`` and
``tools/torch_bench_hopper.py``, small, on the CPU: the JAX tool's row
keys, a resume equal bit for bit to the uninterrupted run, the saved
policy and its ``.npz``, TRPO and the linear policy, the bench's JSON line,
and no run without a GPU unless the CPU is asked for."""

import ast
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from mjrl_tpu_torch import convert
from mjrl_tpu_torch.device import load_pickle
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tools")
SMALL = ["--device", "cpu", "--env", "Hopper-v3", "--ntraj", "4",
         "--hidden", "8", "8"]


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gym():
    return load_tool("torch_train_gym")


def jax_row_keys():
    """The keys ``tools/train_gym.py`` puts in an iteration's row, read
    from its source: the row's dict literal, the logged keys it copies and
    each ``row[...] =``."""
    with open(os.path.join(TOOLS, "train_gym.py")) as f:
        tree = ast.parse(f.read())
    is_row = lambda n: isinstance(n, ast.Name) and n.id == "row"
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if is_row(tgt) and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(tgt, ast.Subscript) and is_row(tgt.value) \
                    and isinstance(tgt.slice, ast.Constant):
                keys.add(tgt.slice.value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple) \
                and any(isinstance(n, ast.Subscript) and is_row(n.value)
                        for n in ast.walk(node)):
            keys |= {e.value for e in node.iter.elts}
    return keys


def printed(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def run(gym, tmp_path_factory):
    """One small training run, two iterations, saved and checkpointed
    after each: (agent, rows, summary, printed lines, save path)."""
    save = str(tmp_path_factory.mktemp("train_gym") / "pol.pkl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        agent, rows, summary = gym.main(SMALL + [
            "--horizon", "4", "--iters", "2", "--ckpt_every", "1",
            "--save", save])
    return agent, rows, summary, printed(buf.getvalue()), save


def test_rows_have_the_jax_tools_keys_and_save_crosses(run):
    agent, rows, summary, lines, save = run
    keys = jax_row_keys()
    assert len(keys) == 11 and {"VF_error_after", "ep_len"} <= keys
    assert [set(r) for r in lines[:2]] == [keys, keys]
    assert [r["iter"] for r in lines[:2]] == [0, 1] and lines[:2] == rows
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert set(lines[2]) == {"env", "solver", "cone", "final_return",
                             "best_return", "iters", "elapsed_s"}
    assert lines[2] == summary and lines[3] == {"saved_policy": save}
    best = max(r["mean_return"] for r in rows)
    assert lines[4]["best_return"] == round(best, 1)

    # the pickles load on the CPU; each .npz gives its policy's numbers
    base = os.path.splitext(save)[0]
    for pkl, npz in ((save, base + ".npz"),
                     (base + "_best.pkl", base + "_best.npz")):
        pol = load_pickle(pkl, device="cpu")
        params, transforms = convert.load_policy_npz(npz)
        fresh = MLP(GymEnv("Hopper-v3", device="cpu").spec,
                    hidden_sizes=(8, 8), device="cpu")
        convert.policy_params_from_numpy(fresh, params, transforms)
        np.testing.assert_array_equal(fresh.get_param_values(),
                                      pol.get_param_values())
        for a, b in zip(fresh.transforms, pol.transforms):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(load_pickle(save, "cpu").get_param_values(),
                                  agent.policy.get_param_values())


def test_resume_reproduces_the_uninterrupted_run(gym, run, capsys,
                                                 tmp_path):
    whole, rows = run[0], run[1]
    args = SMALL + ["--horizon", "4", "--ckpt_every", "1"]
    ck = str(tmp_path / "b")
    gym.main(args + ["--iters", "1", "--ckpt", ck])
    capsys.readouterr()
    resumed, rows2, _ = gym.main(args + ["--iters", "2", "--ckpt", ck,
                                         "--resume"])
    lines = printed(capsys.readouterr().out)
    drop = lambda r: {k: v for k, v in r.items() if k != "elapsed_s"}
    assert [drop(r) for r in lines[:2]] == [drop(r) for r in rows]
    assert [drop(r) for r in rows2] == [drop(r) for r in rows]
    np.testing.assert_array_equal(resumed.policy.get_param_values(),
                                  whole.policy.get_param_values())
    for a, b in zip(resumed.baseline.state[0].values(),
                    whole.baseline.state[0].values()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())


@pytest.mark.parametrize("extra", [["--algo", "trpo"],
                                   ["--policy", "linear"]])
def test_trpo_and_the_linear_policy_run(gym, capsys, extra):
    agent, rows, _ = gym.main(SMALL + ["--horizon", "4", "--iters", "1"]
                              + extra)
    assert len(rows) == 1 and np.isfinite(rows[0]["mean_return"])
    if "trpo" in extra:
        assert type(agent).__name__ == "TRPO"
    else:
        assert agent.policy.config.hidden_sizes == ()


def test_bench_hopper_prints_its_json_line(capsys):
    bench = load_tool("torch_bench_hopper")
    out = bench.main(SMALL + ["--horizon", "4", "--iters", "2"],
                     target=-1e9)
    last = printed(capsys.readouterr().out)[-1]
    assert last == out and last["metric"] == "hopper_npg_seconds_to_3000"
    assert {"value", "unit", "vs_baseline", "iters", "final_return",
            "total_elapsed"} <= set(last)
    # the target is reached at the first iteration, which stops the run
    assert last["iters"] == 1 and last["value"] >= 0.0
    assert last["card"] is None and last["device"] == "cpu"


def test_no_gpu_no_run_unless_the_cpu_is_asked_for(gym):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        gym.main(["--env", "Hopper-v3", "--iters", "1"])
