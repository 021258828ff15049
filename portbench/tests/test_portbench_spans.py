"""The per-layer metrics read from the program's spans (``gae_s``,
``cg_s``, ``reset_s``): a toy traced run of each cell reports those its
entries name, the untraced run none, and the untraced run leaves the
program's span recorder empty: the window and the checked iterations run
with tracing off."""

import pytest

from conftest import bench, workloads

SPAN_METRICS = ("gae_s", "cg_s", "reset_s")


def expected(workload):
    return {m["name"] for m in bench()["per_layer"]
            if m["name"] in SPAN_METRICS
            and workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", workloads())
def test_traced_run_reports_the_span_metrics(toy_run, workload):
    from mjrl_tpu_torch.utils import profiling
    profiling.clear()
    rc, res = toy_run(workload, trace=1)
    assert rc == 0
    assert {"gae_s", "cg_s"} <= expected(workload)
    got = {k for k in res["metrics"] if k in SPAN_METRICS}
    assert got == expected(workload)
    for name in got:
        assert res["metrics"][name]["value"] > 0
        assert res["metrics"][name]["unit"] == "s"
    table = profiling.last_step()
    assert table["fvp"]["count"] == 11
    assert table["control_step"]["count"] == 10      # the toy horizon


@pytest.mark.parametrize("workload", workloads())
def test_untraced_run_records_no_span(toy_run, workload):
    from mjrl_tpu_torch.utils import profiling
    profiling.clear()
    rc, res = toy_run(workload, trace=0)
    assert rc == 0
    assert not set(res["metrics"]) & set(SPAN_METRICS)
    assert profiling.trees() == []
