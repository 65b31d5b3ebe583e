"""The yardstick's counts against hand-computed ones, and the trace
reduction's union and idle attribution."""

import pytest
import torch

from cardbench.roofline import ivf_scan
from cardbench.roofline.peaks import least_seconds, peaks
from cardbench.trace import idle_by_host, union_seconds


def test_scan_work_by_hand():
    live = torch.tensor([10, 0, 5, 7])
    probes = torch.tensor([[0, 2], [2, 3]])
    w = ivf_scan.work(probes, live, rot_dim=4, k_fetch=3)
    # pairs score 10 + 5 + 5 + 7 = 27 rows; lists 0, 2, 3 hold 22 rows
    assert w["flops"] == 2 * 4 * 27
    assert w["bytes"] == 22 * (4 + 4) + 2 * 4 * 2 + 2 * 3 * 8


def test_least_seconds_names_its_bound():
    pk = {"bf16_flops": 100.0, "hbm_bytes_per_s": 10.0}
    assert least_seconds(1000.0, 50.0, pk) == (10.0, "operations")
    assert least_seconds(100.0, 50.0, pk) == (5.0, "bytes")
    assert peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peaks("some other card") is None


def test_widening_and_probes():
    assert ivf_scan.widened(16, 1024, None) == 16
    assert ivf_scan.widened(16, 1024, 0.10) == 128
    assert ivf_scan.widened(16, 1024, 0.5) == 32
    assert ivf_scan.widened(16, 64, 0.01) == 64
    centers = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    q = torch.tensor([[9.0, 1.0], [1.0, 8.0]])
    assert ivf_scan.probes(q, centers, 2).tolist() == [[1, 0], [2, 0]]


def test_union_and_idle_attribution():
    busy, gaps = union_seconds([(0, 10), (5, 20), (30, 40)])
    assert busy == pytest.approx(30e-9) and gaps == [(20, 30)]
    host = [(0, 100, "outer"), (18, 35, "aten::nonzero"), (50, 60, "x")]
    out = idle_by_host([(20, 30), (40, 48), (60, 70)], host)
    assert out == pytest.approx({"aten::nonzero": 10e-9, "outer": 18e-9})
