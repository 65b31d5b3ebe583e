"""A run's last line holds exactly the contract's keys, the numbers
compared come last in it and last on standard error."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from cardbench import harness
from cardbench.tests.tiny import make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("line"))


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(root, trace):
    line = harness.run_cell(root, "sift1m-ivfpq.b10k", 2**31 + 5, 0.3,
                            bool(trace), device="cpu")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(line)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert list(last) == keys
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(last["metrics"]) <= {
            "search_ms.host_paced", "refine_ms.host_paced",
            "k1_roofline.host_paced", "idle_share.host_paced"}
    else:
        assert set(last["metrics"]) == {"qps.host_paced", "recall_at_10",
                                        "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()
    assert tail[-1] == "correct = True"
    assert [t.split()[1] for t in tail[-len(last["checks"]) - 1:-1]] == \
        list(last["checks"])
