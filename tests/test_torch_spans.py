"""The port's spans (``repro_torch.spans``) on the CPU: off by default and
changing nothing when on, seen by ``torch.profiler``, nested and counted
as the FL engine, the trainer and the kernel wrappers place them; and the
benchmark's reader of them (``portbench/yardstick/spans.py``), which keeps
the first traced pass.

On the CPU a span has host times only; the device times (CUDA events) are
the card's, read by the benchmark's ``--trace 1`` runs.
"""
import json
import types
from pathlib import Path

import pytest
import torch

import repro_torch.configs as C
from repro_torch import quickstart, spans
from repro_torch.data import batches_for
from repro_torch.fl.engine import FLEngine
from repro_torch.fl.registry import bicompfl_spec
from repro_torch.kernels import ops
from repro_torch.launch import train as TR
from repro_torch.tree import tree_leaves

from portbench.yardstick import spans as yardstick

FL_CFG = dict(n_train=200, n_test=60, hw=6, widths=(16,), local_epochs=1)


@pytest.fixture(autouse=True)
def _empty_buffer():
    """Each test starts and ends with no span recorded, on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(threads)


def _fl(allocation="fixed", participation=1.0):
    cfg = dict(FL_CFG, allocation=allocation)
    task, spec, shards = quickstart.build("cpu", cfg)
    if participation < 1:
        spec = bicompfl_spec("PR", allocation=quickstart.make_allocation(
            dict(quickstart.CONFIG, **cfg)), n_is=16, n_dl=3, participation=participation)
    return FLEngine(task, spec), shards


def _fl_run(mode, allocation="fixed", participation=1.0, rounds=3, eval_every=1):
    eng, shards = _fl(allocation, participation)
    return eng.run(shards, rounds=rounds, seed=5, eval_every=eval_every, mode=mode)


def _trainer(compression):
    cfg = C.get("qwen3-1.7b").reduced()
    return cfg, TR.Trainer(cfg, lr=1e-3, microbatches=2, kv_chunk=16,
                           grad_compression=compression, seed=3, device="cpu")


def _train_steps(compression, steps=2):
    cfg, tr = _trainer(compression)
    losses = [tr.step(b) for b in batches_for(cfg, 4, 16, n=steps)]
    return losses, tr.params


def _names(recs):
    return [r.name for r in recs]


def _by_index(recs):
    return {r.index: r for r in recs}


# ---------------------------------------------------------------------------
# Off by default; on, nothing that runs changes
# ---------------------------------------------------------------------------


def test_spans_are_off_without_a_profiler_or_recording():
    assert spans.span("a") is spans.span("b", "cpu")
    _fl_run("fused")
    _train_steps(None, steps=1)
    assert spans.records() == [] and spans.dropped() == 0


def _same_fl(a, b):
    assert torch.equal(a["theta"], b["theta"]) and torch.equal(a["theta_hat"], b["theta_hat"])
    assert a["history"] == b["history"] and a["meter"] == b["meter"]


@pytest.mark.parametrize("mode,allocation,participation", [
    ("fused", "fixed", 1.0), ("fused", "fixed", 0.5), ("fused", "adaptive", 1.0),
    ("host", "fixed", 1.0), ("host", "adaptive", 1.0)])
def test_recording_fl_runs_changes_nothing(mode, allocation, participation):
    off = _fl_run(mode, allocation, participation)
    with spans.recording():
        on = _fl_run(mode, allocation, participation)
    assert spans.records()
    _same_fl(off, on)


@pytest.mark.parametrize("compression", [None, "stochastic_sign"])
def test_recording_a_train_step_changes_nothing(compression):
    off_losses, off_params = _train_steps(compression)
    with spans.recording():
        on_losses, on_params = _train_steps(compression)
    assert spans.records()
    assert off_losses == on_losses
    for a, b in zip(tree_leaves(off_params), tree_leaves(on_params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Seen by the profiler, nested and counted where the program places them
# ---------------------------------------------------------------------------


def test_a_profiler_session_turns_the_spans_on_and_sees_them():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fl_run("fused", rounds=2)
        _train_steps("stochastic_sign", steps=1)
    seen = {e.name for e in prof.events()}
    want = {"fl.job", "fl.round", "fl.train", "fl.codec", "fl.eval", "fl.book",
            "train.step", "train.fwd_bwd", "train.sign", "train.update", "train.sync"}
    assert want <= seen
    assert want == set(_names(spans.records()))
    assert spans.span("after") is spans.span("again")       # the session closed: off


def _parents(recs, name):
    at = _by_index(recs)
    return {at[r.parent].name if r.parent >= 0 else None for r in recs if r.name == name}


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_fl_spans_nest_and_count_a_round_each(mode):
    with spans.recording():
        out = _fl_run(mode, rounds=3, eval_every=2)
    recs = spans.records()
    names = _names(recs)
    evals = len(out["history"])                         # rounds 2 and 3
    assert evals == 2
    assert names.count("fl.job") == 1 and names.count("fl.round") == 3
    assert names.count("fl.train") == 3 and names.count("fl.codec") == 3
    assert names.count("fl.eval") == evals
    assert names.count("fl.book") == (1 if mode == "fused" else 0)
    assert _parents(recs, "fl.job") == {None}
    assert _parents(recs, "fl.round") == {"fl.job"}
    for name in ("fl.train", "fl.codec", "fl.eval"):
        assert _parents(recs, name) == {"fl.round"}
    assert all(r.device_ms is None and r.end_ns >= r.start_ns for r in recs)


def test_adaptive_fused_rounds_are_a_stats_and_a_bucket_graph():
    with spans.recording():
        _fl_run("fused", allocation="adaptive", rounds=3)
    names = _names(spans.records())
    assert names.count("fl.train") == names.count("fl.codec") == names.count("fl.round") == 3


@pytest.mark.parametrize("compression", [None, "stochastic_sign"])
def test_train_spans_nest_and_count_a_step_each(compression):
    cfg, tr = _trainer(compression)
    batch = next(iter(batches_for(cfg, 4, 16, n=1)))
    with spans.recording():
        tr.step(batch)
    recs = spans.records()
    names = _names(recs)
    assert names.count("train.step") == 1 and names.count("train.update") == 1
    assert names.count("train.fwd_bwd") == 2                    # one a microbatch
    assert names.count("train.sign") == (1 if compression else 0)
    assert names.count("train.sync") == 1
    for name in ("train.fwd_bwd", "train.update", "train.sync") + (
            ("train.sign",) if compression else ()):
        assert _parents(recs, name) == {"train.step"}
    assert not any(n.startswith("kernel.") for n in names)      # the CPU route


def test_a_kernel_launch_on_the_card_route_is_a_span(monkeypatch):
    """The card branch of ``ops._route`` (a stand-in kernel and a tensor
    that says it lives on the card; no CUDA event on the CPU): one
    ``kernel.<name>`` span inside the caller's, the launch counted once."""
    monkeypatch.setattr(spans, "_event_pair_start", lambda device: None)

    def fake():
        pass

    fake.launches, fake.span_name = 0, "kernel.fake"
    t = types.SimpleNamespace(device=torch.device("cuda"))
    with spans.recording(), spans.span("caller"):
        out = ops._route(fake, lambda: "plain", lambda: "kernel", t, work=lambda: None)
        ops._route(fake, lambda: "plain", lambda: "kernel",
                   types.SimpleNamespace(device=torch.device("cpu")))
    recs = spans.records()
    assert out == "kernel" and fake.launches == 1
    assert _names(recs) == ["caller", "kernel.fake"] and recs[1].parent == 0
    assert all(f.span_name == f"kernel.{f.__name__}" for f in (
        ops.flash_attention, ops.mrc_fixed_encode, ops.segment_mrc_encode, ops.rwkv_time_mix))


# ---------------------------------------------------------------------------
# The buffer: bounded, summarised, read outside spans only
# ---------------------------------------------------------------------------


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.recording():
        with spans.span("outer"):
            for _ in range(4):
                with spans.span("inner"):
                    pass
    recs = spans.records()
    assert _names(recs) == ["outer", "inner", "inner"] and spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_records_and_clear_refuse_inside_a_span():
    with spans.recording(), spans.span("open"):
        with pytest.raises(RuntimeError):
            spans.records()
        with pytest.raises(RuntimeError):
            spans.clear()
    assert _names(spans.records()) == ["open"]


def test_meta_and_cpu_work_get_host_times_only():
    with spans.recording():
        for dev in (None, "cpu", "meta", torch.device("meta")):
            with spans.span("x", dev):
                pass
    assert [r.device_ms for r in spans.records()] == [None] * 4


def _rec(i, name, parent, start, end, dev=None):
    return spans.Record(i, name, parent, int(start * 1e6), int(end * 1e6), dev)


def test_summary_takes_self_time_as_the_part_no_child_covers():
    recs = [_rec(0, "a", -1, 0, 10), _rec(1, "b", 0, 1, 4), _rec(2, "b", 0, 3, 6),
            _rec(3, "c", 1, 2, 3), _rec(4, "d", -1, 20, 30, dev=12.0),
            _rec(5, "e", 4, 21, 22, dev=2.5), _rec(6, "e", 4, 23, 25, dev=4.0)]
    s = spans.summary(recs)
    assert s["a"] == {"calls": 1, "host_ms": 10.0, "device_ms": None, "self_ms": 5.0}
    assert s["b"]["calls"] == 2 and s["b"]["host_ms"] == 6.0 and s["b"]["self_ms"] == 5.0
    assert s["d"]["device_ms"] == 12.0 and s["d"]["self_ms"] == 5.5
    assert s["e"] == {"calls": 2, "host_ms": 3.0, "device_ms": 6.5, "self_ms": 6.5}


# ---------------------------------------------------------------------------
# The benchmark's reader keeps the first traced pass
# ---------------------------------------------------------------------------


def _two_passes():
    """Two passes of two FL rounds: the second (the labelling pass) slower."""
    out, i = [], 0
    for scale in (1.0, 5.0):
        for _ in range(2):
            r = i
            out.append(_rec(r, "fl.round", -1, i, i + 1, dev=100.0 * scale))
            out.append(_rec(r + 1, "fl.train", r, i, i + 0.5, dev=90.0 * scale))
            out.append(_rec(r + 2, "fl.codec", r, i + 0.5, i + 0.6, dev=2.0 * scale))
            out.append(_rec(r + 3, "kernel.k", r + 2, i + 0.5, i + 0.52))
            i += 4
    return out


@pytest.mark.parametrize("count,train,codec,kernel", [
    (2, 90.0, 2.0, 0.02), (1, 90.0, 2.0, 0.02), (4, 270.0, 6.0, 0.02)])
def test_the_yardstick_reads_the_first_pass(monkeypatch, count, train, codec, kernel):
    monkeypatch.setattr(spans, "records", _two_passes)
    recs = yardstick.first_pass("fl.round", count)
    assert len(recs) == 4 * count
    assert yardstick.device_ms(recs, lambda n: n == "fl.train", count) == pytest.approx(train)
    assert yardstick.device_ms(recs, lambda n: n == "fl.codec", count) == pytest.approx(codec)
    assert yardstick.host_ms(recs, lambda n: n.startswith("kernel."), count) == \
        pytest.approx(kernel)


def test_the_yardstick_finds_nothing_where_units_are_short_or_absent(monkeypatch):
    monkeypatch.setattr(spans, "records", _two_passes)
    assert yardstick.first_pass("fl.round", 5) is None
    assert yardstick.first_pass("train.step", 1) is None
    assert yardstick.first_pass("fl.round", 0) is None
    recs = yardstick.first_pass("fl.round", 2)
    assert yardstick.device_ms(recs, lambda n: n == "fl.eval", 2) is None
    assert yardstick.device_ms(recs, lambda n: n == "kernel.k", 2) is None   # host only
    assert yardstick.device_ms(None, lambda n: True, 2) is None
    assert yardstick.host_ms(None, lambda n: True, 2) is None


SPEC = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
# The per-layer metrics that read the program's spans, and what each reads
# from ``_cell_passes`` per round or step.
SPAN_METRICS = {"fl.train_ms": 300.0, "fl.codec_ms": 1.5, "train.fwd_bwd_ms": 1400.0,
                "train.sign_ms": 2400.0, "train.update_ms": 115.0,
                "train.kernel_host_ms": 0.3}


def _cell_passes(fl: bool):
    """Two passes of two rounds or steps, the second five times slower, as
    a ``--trace 1`` run records them (no sign spans in a plain step)."""
    out = []

    def add(name, parent, host_ms, dev):
        t = len(out)
        out.append(_rec(t, name, parent, t, t + host_ms, dev))
        return t

    for scale in (1.0, 5.0):
        for _ in range(2):
            if fl:
                u = add("fl.round", -1, 1.0, 310.0 * scale)
                add("fl.train", u, 0.9, 300.0 * scale)
                add("fl.codec", u, 0.1, 1.5 * scale)
            else:
                u = add("train.step", -1, 1.0, 4000.0 * scale)
                for _ in range(2):
                    f = add("train.fwd_bwd", u, 0.5, 700.0 * scale)
                    for _ in range(3):
                        add("kernel.flash_attention", f, 0.05 * scale, 0.2)
                add("train.sign", u, 0.3, 2400.0 * scale)
                add("train.update", u, 0.1, 115.0 * scale)
    return out


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cells_span_metrics_read_the_first_pass(monkeypatch, cell):
    """Through the benchmark's own reader files: two metrics in the FL
    cell, four in the signed training cell, three in the plain one."""
    from portbench import harness, run
    fl = cell.startswith("fl-")
    recs = [r for r in _cell_passes(fl) if r.name != "train.sign" or "sign" in cell]
    monkeypatch.setattr(spans, "records", lambda: recs)
    names = [m["name"] for m in run.for_cell(SPEC["per_layer"], cell)
             if m["name"] in SPAN_METRICS]
    assert len(names) == (2 if fl else 4 if "sign" in cell else 3)
    ctx = {"rounds": 2} if fl else {"steps": 2}
    for name in names:
        assert harness._reader(name)(None, ctx) == pytest.approx(SPAN_METRICS[name], rel=1e-5)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert all(harness._reader(name)(None, ctx) is None for name in names)
