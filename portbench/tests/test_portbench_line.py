"""Each driver, rehearsed on the CPU at a tiny size, gives a last line of the
benchmark's shape; a traced window gives every per-layer metric of its
cells, a breakdown and the device's busy and window seconds."""
import json
from pathlib import Path

import pytest
import torch
from conftest import rehearse, tiny_lm

from portbench import harness, run
from portbench.drivers import fl_jobs, train_steps
from portbench.yardstick.trace import Trace, label_gaps

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


def _e2e(cell):
    return run.for_cell(SPEC["end_to_end"], cell)


def _check_shape(line, cell, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    want = (run.for_cell(SPEC["per_layer"], cell) if trace else _e2e(cell))
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in want:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


@pytest.fixture
def named_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


def test_fl_line(tiny_fl, named_card):
    cfg, traffic = tiny_fl
    res = rehearse(fl_jobs, cfg, traffic)
    line = harness.result_line(res, _e2e("fl-mlp.gr-fixed"), [], trace=False, log=print)
    _check_shape(line, "fl-mlp.gr-fixed", False)
    assert line["correct"] is True


@pytest.mark.parametrize("cell,traffic_name", [("qwen3-1.7b.train", "train"),
                                               ("qwen3-1.7b.train-sign", "train-sign")])
def test_train_line(cell, traffic_name, named_card):
    cfg, traffic = tiny_lm(traffic_name)
    res = rehearse(train_steps, cfg, traffic)
    line = harness.result_line(res, _e2e(cell), [], trace=False, log=print)
    _check_shape(line, cell, False)


def _fake_trace():
    ms = 1_000_000
    ops = [("void mrc_encode_kernel<32>", 0, 2 * ms), ("nvjet_tst_gemm", 1 * ms, 5 * ms),
           ("void tf32::flash_attn_tf32<128>", 6 * ms, 8 * ms),
           ("void at::vectorized_elementwise_kernel", 9 * ms, 10 * ms)]
    host = [("cudaGraphLaunch", 0, 3 * ms), ("cudaStreamSynchronize", 5 * ms, 12 * ms)]
    return Trace(ops, 12e-3, label_gaps(ops, host, 0, 12 * ms))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_traced_line(cell, named_card):
    """Every per-layer metric of the cell is read from a traced window,
    shares stay within 0..100, and the breakdown labels the gaps."""
    tr = _fake_trace()
    if cell.startswith("fl-"):
        ctx = {"rounds": 2, "fl_flops": 1e9}
    else:
        ctx = {"steps": 2, "train_flops": 1e12, "flash_bound_s": 1e-4}
    res = harness.Result(attempted=1, failed=0, e2e={}, checks=[("x", 0.0, 0.0)],
                         memory_peak_bytes=1, trace=tr, ctx=ctx)
    line = harness.result_line(res, _e2e(cell), run.for_cell(SPEC["per_layer"], cell), trace=True,
                               log=print)
    _check_shape(line, cell, True)
    assert line["device"]["busy_s"] == pytest.approx(8e-3)
    assert line["device"]["window_s"] == pytest.approx(12e-3)
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"cudaStreamSynchronize": 4e-3})
    assert line["breakdown"]["device_ops"][0][0] == "nvjet_tst_gemm"
