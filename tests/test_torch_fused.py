"""The port's fused path (``FLEngine.run(mode="fused")``, chosen by
``mode="auto"``) against its own host loop and the reference's fused
``lax.scan``, on the CPU.

On the CPU the fused path runs the functions the card captures as CUDA
graphs eagerly, in the same order, on the same static buffers.  Mirrors
``tests/test_fused_parity.py``'s setups (3 clients, d = 1472, n_is 16,
blocks of 64, ``all_schemes(..., reset_period=2)``):

* static plans: for every registry scheme the port's fused run equals the
  port's host run bit for bit (histories, meter, theta, theta_hat), and the
  reference's fused run bit for bit on the BiCompFL (mask) schemes, also on
  a partial cohort under both cohort RNGs and with ``eval_every=2``; on
  the conventional-FL (delta) schemes the bits and the meter equal the
  reference's and the models agree within ``THETA_ATOL``, the port's
  standing parity there (its dense deltas and Adam sum in torch's order:
  ``test_torch_cfl.py``, ``test_torch_baselines.py``);
* the bucket API (``select_bucket``, ``finalize_plan``) held to the
  reference's outputs on recorded and constructed profiles, and the XLA
  orders it emulates (``scan_cumsum``, ``searchsorted_left``);
* adaptive plans: the port's fused run against the reference's (buckets,
  segment ids, bits, indices, theta), and at the quickstart's full width
  (AdaptiveAllocation(n_is=64), 4 rounds): 69120 bits, the reference's
  default-mode figure, where the host loop books 94320;
* the capture cache, the eligibility rules and the quickstart entry point.

The card's capture and replay run only on the card (``chip_smoke.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import mrc as jm
from repro.fl import channels as jch
from repro.fl import registry as jreg
from repro.fl.data import make_synthetic, partition_iid
from repro.fl.engine import FLEngine as JEngine
from repro.fl.nets import make_mlp
from repro.fl.tasks import make_cfl_task, make_mask_task
from repro_torch import convert, quickstart
from repro_torch.core import blocks as tblocks
from repro_torch.core import mrc as tm
from repro_torch.fl import channels as tch
from repro_torch.fl import registry as treg
from repro_torch.fl.engine import FLEngine as TEngine, run_spec

N, D, N_IS, BLOCK, SEED = 3, 1472, 16, 64, 11
J_SCHEMES = jreg.all_schemes(n=N, d=D, n_is=N_IS, block=BLOCK, reset_period=2)
T_SCHEMES = treg.all_schemes(n=N, d=D, n_is=N_IS, block=BLOCK, reset_period=2)
# The conventional-FL schemes' models against the reference's, and their
# accuracy on 120 test points: the tolerances of test_torch_cfl.py and
# test_torch_baselines.py, which hold the port's host loop to the reference.
THETA_ATOL, ACC_BAND = 1e-6, 0.02


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file: the suite's workers share one
    machine, and full-width PR runs on every core of each worker
    oversubscribe it many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mask_setup():
    k = jax.random.PRNGKey(3)
    train, test = make_synthetic(k, n_train=240, n_test=120, hw=6, noise=0.5)
    shards = partition_iid(jax.random.fold_in(k, 1), train, N, 80)
    net = make_mlp(in_dim=36, widths=(32,), signed_constant=True)
    task = make_mask_task(net, jax.random.fold_in(k, 2), test.x, test.y,
                          local_epochs=1, batch_size=40)
    ttask = convert.mask_task(task.w0_flat, task.x_test, task.y_test, dims=(36, 32, 10),
                              device="cpu", local_epochs=1, batch_size=40, lr=task.lr)
    return task, shards, ttask, convert.dataset(shards.x, shards.y, "cpu")


@pytest.fixture(scope="module")
def cfl_setup():
    k = jax.random.PRNGKey(4)
    train, test = make_synthetic(k, n_train=240, n_test=120, hw=6, noise=0.5)
    shards = partition_iid(jax.random.fold_in(k, 1), train, N, 80)
    net = make_mlp(in_dim=36, widths=(32,))
    task, theta0 = make_cfl_task(net, jax.random.fold_in(k, 2), test.x, test.y,
                                 local_epochs=2, batch_size=40, local_lr=3e-3)
    ttask, ttheta0 = convert.cfl_task(theta0, task.x_test, task.y_test, dims=(36, 32, 10),
                                      device="cpu", local_epochs=2, batch_size=40,
                                      local_lr=3e-3)
    assert int(theta0.shape[0]) == D
    return task, theta0, shards, ttask, ttheta0, convert.dataset(shards.x, shards.y, "cpu")


def _assert_identical(want, got):
    """Bit for bit: histories, meter, theta, theta_hat, cohorts, accuracies
    (``want`` either package's result, ``got`` the port's)."""
    assert len(got["history"]) == len(want["history"])
    for hw, hg in zip(want["history"], got["history"]):
        assert set(hg) == set(hw)
        for key in hw:
            assert hg[key] == hw[key], (key, hw, hg)
    assert got["meter"] == want["meter"]
    np.testing.assert_array_equal(got["theta"].numpy(), np.asarray(want["theta"]))
    np.testing.assert_array_equal(got["theta_hat"].numpy(), np.asarray(want["theta_hat"]))
    np.testing.assert_array_equal(got["active_schedule"], want["active_schedule"])
    assert got["final_acc"] == want["final_acc"] and got["max_acc"] == want["max_acc"]


def _assert_close(want, got):
    """The delta schemes against the reference: bits and meter exactly, the
    models within THETA_ATOL, accuracies within ACC_BAND."""
    assert [h["cum_bits"] for h in got["history"]] == [h["cum_bits"] for h in want["history"]]
    assert [h["round"] for h in got["history"]] == [h["round"] for h in want["history"]]
    assert got["meter"] == want["meter"]
    for key in ("theta", "theta_hat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=THETA_ATOL,
                                   rtol=0, err_msg=key)
    for hw, hg in zip(want["history"], got["history"]):
        assert abs(hw["acc"] - hg["acc"]) <= ACC_BAND, (hw, hg)


def _three_runs(jtask, jfac, jshards, ttask, tfac, tshards, jtheta0=None, ttheta0=None,
                rounds=3, **kw):
    """(reference fused, port host, port fused) of one scheme."""
    ref = JEngine(jtask, jfac()).run(jshards, jtheta0, rounds=rounds, seed=SEED,
                                     mode="fused", **kw)
    host = TEngine(ttask, tfac()).run(tshards, ttheta0, rounds=rounds, seed=SEED,
                                      mode="host", **kw)
    fused = TEngine(ttask, tfac()).run(tshards, ttheta0, rounds=rounds, seed=SEED,
                                       mode="fused", **kw)
    assert (ref["mode"], host["mode"], fused["mode"]) == ("fused", "host", "fused")
    return ref, host, fused


# ---------------------------------------------------------------------------
# Static plans: every registry scheme.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(T_SCHEMES)), ids=[s[0] for s in T_SCHEMES])
def test_fused_matches_host_and_reference(mask_setup, cfl_setup, i):
    """3 rounds (CSER and LIEC flush after round 2): the port's fused run
    equals its host run bit for bit, and the reference's fused run bit for
    bit (mask schemes) or within the port's standing tolerance (delta)."""
    (name, kind, tfac), (jname, jkind, jfac) = T_SCHEMES[i], J_SCHEMES[i]
    assert (name, kind) == (jname, jkind)
    if kind == "mask":
        task, shards, ttask, tshards = mask_setup
        ref, host, fused = _three_runs(task, jfac, shards, ttask, tfac, tshards)
    else:
        task, theta0, shards, ttask, ttheta0, tshards = cfl_setup
        ref, host, fused = _three_runs(task, jfac, shards, ttask, tfac, tshards,
                                       theta0, ttheta0)
    print(f"{name}: bits {fused['meter']['total_bits']}, "
          f"acc {[h['acc'] for h in fused['history']]}")
    _assert_identical(host, fused)
    (_assert_identical if kind == "mask" else _assert_close)(ref, fused)


@pytest.mark.parametrize("cohort_rng", ["numpy", "jax"])
def test_fused_partial_participation(mask_setup, cohort_rng):
    """PR at participation 0.5, round(0.5 * 3) = 2 clients a round (half to
    even): the same cohorts, bits and estimates (stale rows for the client
    left out) in all three runs."""
    task, shards, ttask, tshards = mask_setup

    def fac(reg):
        return lambda: reg.bicompfl_spec("PR", allocation=(
            jblocks if reg is jreg else tblocks).FixedAllocation(BLOCK), n_is=N_IS,
            n_dl=N, participation=0.5)

    ref, host, fused = _three_runs(task, fac(jreg), shards, ttask, fac(treg), tshards,
                                   cohort_rng=cohort_rng)
    assert fused["active_schedule"].shape == (3, 2)
    _assert_identical(host, fused)
    _assert_identical(ref, fused)


def test_fused_eval_cadence(mask_setup):
    """Only the eval rounds (every second, and the last) replay the eval."""
    task, shards, ttask, tshards = mask_setup
    ref, host, fused = _three_runs(
        task, lambda: jreg.bicompfl_spec("GR", allocation=jblocks.FixedAllocation(BLOCK),
                                         n_is=N_IS, n_dl=N), shards,
        ttask, lambda: treg.bicompfl_spec("GR", allocation=tblocks.FixedAllocation(BLOCK),
                                          n_is=N_IS, n_dl=N), tshards, eval_every=2)
    assert [h["round"] for h in fused["history"]] == [2, 3]
    _assert_identical(host, fused)
    _assert_identical(ref, fused)


# ---------------------------------------------------------------------------
# The bucket API against the reference's.
# ---------------------------------------------------------------------------


class _JProfiles(jblocks.AdaptiveAllocation):
    """Records every profile the reference's fused run feeds its buckets."""

    def select_bucket(self, stats, d):
        jax.debug.callback(lambda p: self.log.append(np.asarray(p)), stats["profile"])
        return super().select_bucket(stats, d)


@pytest.fixture(scope="module")
def profiles(mask_setup):
    """KL profiles: 3 rounds of the reference's fused GR run (adaptive,
    n_is 16), and constructed ones -- a zero head (the first bin
    edge at 0: an empty segment 0), single spikes (duplicate edges
    collapse), all zeros, and rough random ones at d = 28160."""
    task, shards, _, _ = mask_setup
    alloc = _JProfiles(n_is=N_IS)
    alloc.log = out = []
    JEngine(task, jreg.bicompfl_spec("GR", allocation=alloc, n_is=N_IS, n_dl=N)).run(
        shards, rounds=3, seed=SEED, mode="fused")
    rng = np.random.default_rng(0)
    for d in (D, 28160, 1000):
        base = (rng.random(d) ** 6 * 0.3).astype(np.float32)
        head = base.copy()
        head[: d // 3] = 0.0
        spike = base.copy()
        spike[d // 2] += 40.0
        out += [base, head, spike, np.zeros(d, np.float32)]
    return [p.astype(np.float32) for p in out]


ALLOCS = [("Adaptive", {}), ("Adaptive", {"target_ratio": 0.02}),
          ("Adaptive", {"target_ratio": 0.02, "min_blocks": 7}),
          ("AdaptiveAvg", {}), ("AdaptiveAvg", {"min_block": 32, "max_block": 512})]


def _pair(name, kw):
    return (getattr(jblocks, f"{name}Allocation")(n_is=N_IS, **kw),
            getattr(tblocks, f"{name}Allocation")(n_is=N_IS, **kw))


_JITTED: dict = {}


def _ref_select(ja, key, d):
    """The reference's ``select_bucket`` under ``jax.jit`` (as its fused
    scan compiles it), one compile per (allocation, d)."""
    k = ("select", key, d)
    if k not in _JITTED:
        _JITTED[k] = jax.jit(lambda total: ja.select_bucket({"total": total}, d))
    return _JITTED[k]


def _ref_finalize(ja, key, d, i):
    """The reference's ``finalize_plan`` of template ``i`` under ``jax.jit``:
    (seg_ids, billable, overhead)."""
    k = ("finalize", key, d, i)
    if k not in _JITTED:
        tmpl = ja.bucket_plans(d)[i]
        _JITTED[k] = jax.jit(lambda klp: (lambda p: (p.seg_ids, p.billable_blocks,
                                                     p.overhead_bits))(
            ja.finalize_plan(tmpl, {"profile": klp}, d)))
    return _JITTED[k]


def _templates(n):
    """The templates checked: every third, and the last (the cap)."""
    return sorted(set(range(0, n, 3)) | {n - 1})


@pytest.mark.parametrize("name,kw", ALLOCS)
def test_bucket_api_matches_reference(profiles, name, kw):
    """On every profile, from the reference's own total: the same bucket,
    and for every third template and the last the same segment ids,
    billable count and overhead (constructed profiles: an empty segment 0,
    collapsed edges)."""
    key = (name, tuple(sorted(kw.items())))
    for klp in profiles:
        d = klp.shape[0]
        ja, ta = _pair(name, kw)
        total = jnp.sum(jnp.asarray(klp))
        tstats = {"profile": torch.from_numpy(klp),
                  "total": torch.tensor(np.asarray(total), dtype=torch.float32)}
        assert int(ta.select_bucket(tstats, d)) == int(_ref_select(ja, key, d)(total))
        jplans, tplans = ja.bucket_plans(d), ta.bucket_plans(d)
        assert [(p.size, p.n_blocks, p.overhead_bits) for p in tplans] == \
            [(p.size, p.n_blocks, p.overhead_bits) for p in jplans]
        for i in _templates(len(tplans)):
            tp = ta.finalize_plan(tplans[i], tstats, d)
            if name == "AdaptiveAvg":
                assert ja.finalize_plan(jplans[i], {}, d) is jplans[i] and tp is tplans[i]
                continue
            seg, billable, overhead = (np.asarray(v) for v in
                                       _ref_finalize(ja, key, d, i)(jnp.asarray(klp)))
            assert tp.seg_ids.dtype == torch.int32
            np.testing.assert_array_equal(tp.seg_ids.numpy(), seg)
            assert int(tp.billable_blocks) == int(billable) == int(tp.seg_ids[-1]) + 1
            assert int(tp.overhead_bits) == int(overhead)
            assert bool((tp.seg_ids[1:] >= tp.seg_ids[:-1]).all())


def test_bucket_from_the_ports_own_total(profiles):
    """The fused path's total is torch's sum of the profile, which may sit
    an ulp from XLA's ``jnp.sum`` (another order).  The bucket must still be
    the reference's, except where the reference's total lies within an ulp
    of a bucket edge (counted; none is expected)."""
    near = 0
    for name, kw in ALLOCS:
        key = (name, tuple(sorted(kw.items())))
        for klp in profiles:
            d = klp.shape[0]
            ja, ta = _pair(name, kw)
            jt = jnp.sum(jnp.asarray(klp))
            tt = torch.from_numpy(klp).sum()
            want = int(_ref_select(ja, key, d)(jt))
            got = int(ta.select_bucket({"total": tt}, d))
            if got != want:
                lo, hi = np.nextafter(np.float32(jt), np.float32(-np.inf)), \
                    np.nextafter(np.float32(jt), np.float32(np.inf))
                edge = {int(_ref_select(ja, key, d)(jnp.float32(v))) for v in (lo, hi)}
                assert len(edge) > 1, (name, kw, d, float(jt), float(tt), got, want)
                near += 1
    print(f"buckets within an ulp of an edge: {near}")


@pytest.mark.parametrize("d", [7, 16, 17, 100, 1000, 1472, 5000, 28160, 28161])
def test_scan_cumsum_is_xlas(d):
    """0 mismatches against ``jax.jit(jnp.cumsum)`` (torch's cumsum and a
    sequential sum both differ at d = 28160)."""
    x = (np.random.default_rng(d).random(d) ** 3 * 0.01).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    np.testing.assert_array_equal(tblocks.scan_cumsum(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 5, 64, 1000, 28160])
def test_searchsorted_left_is_jaxs(n):
    """jax's scan binary search, also on an array that steps back."""
    rng = np.random.default_rng(n)
    a = np.cumsum(rng.random(n).astype(np.float32) - 0.05).astype(np.float32)
    v = np.concatenate([rng.uniform(a.min() - 1, a.max() + 1, 200), a[:: max(1, n // 7)]])
    v = v.astype(np.float32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(a), jnp.asarray(v)))
    got = tblocks.searchsorted_left(torch.from_numpy(a), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Adaptive plans: whole runs.
# ---------------------------------------------------------------------------


class _JSegRec(jblocks.AdaptiveAllocation):
    def finalize_plan(self, template, stats, d):
        p = super().finalize_plan(template, stats, d)
        jax.debug.callback(lambda s: self.log.append(np.asarray(s)), p.seg_ids)
        return p


class _TSegRec(tblocks.AdaptiveAllocation):
    def finalize_plan(self, template, stats, d):
        p = super().finalize_plan(template, stats, d)
        self.log.append(p.seg_ids.numpy().copy())
        return p


class _JUpRec(jch.MRCAdaptiveChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        jax.debug.callback(lambda i: self.log.append(np.asarray(i)), idxs)
        return q_hat, bits, state


class _TUpRec(tch.MRCAdaptiveChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append(idxs.numpy())
        return q_hat, bits, state


def _recorded_specs(variant, n_is, n_dl, participation=1.0, **alloc_kw):
    ja, ta = _JSegRec(n_is=n_is, **alloc_kw), _TSegRec(n_is=n_is, **alloc_kw)
    ja.log, ta.log = [], []
    js = jreg.bicompfl_spec(variant, allocation=ja, n_is=n_is, n_dl=n_dl,
                            participation=participation)
    ts = treg.bicompfl_spec(variant, allocation=ta, n_is=n_is, n_dl=n_dl,
                            participation=participation)
    shared = variant.startswith("GR")
    js.uplink, ts.uplink = _JUpRec(n_is=n_is, shared=shared), _TUpRec(n_is=n_is, shared=shared)
    js.uplink.log, ts.uplink.log = [], []
    return js, ts


def _assert_adaptive_runs_equal(js, ts, jout, tout):
    """Segment ids, every MRC index, bits, meter and the model all equal."""
    assert len(ts.allocation.log) == len(js.allocation.log)
    for r, (a, b) in enumerate(zip(js.allocation.log, ts.allocation.log)):
        np.testing.assert_array_equal(b, a, err_msg=f"seg_ids round {r}")
    for r, (a, b) in enumerate(zip(js.uplink.log, ts.uplink.log)):
        np.testing.assert_array_equal(b, a.reshape(b.shape), err_msg=f"indices round {r}")
    _assert_identical(jout, tout)


@pytest.mark.parametrize("variant,participation,cohort_rng", [
    ("GR", 1.0, "numpy"), ("PR", 0.67, "numpy"), ("PR", 0.67, "jax")])
def test_fused_adaptive_matches_reference(mask_setup, variant, participation, cohort_rng):
    """AdaptiveAllocation(target_ratio=0.02) on the default bucket grid, 3
    rounds: segment ids, indices, bits and the model equal the reference's
    fused run's."""
    task, shards, ttask, tshards = mask_setup
    js, ts = _recorded_specs(variant, N_IS, N, participation, target_ratio=0.02)
    jout = JEngine(task, js).run(shards, rounds=3, seed=SEED, mode="fused",
                                 cohort_rng=cohort_rng)
    tout = TEngine(ttask, ts).run(tshards, rounds=3, seed=SEED, cohort_rng=cohort_rng)
    print(f"{variant}: buckets {tout['buckets']}, bits {tout['meter']['total_bits']}")
    assert tout["mode"] == "fused" and len(tout["buckets"]) == 3
    _assert_adaptive_runs_equal(js, ts, jout, tout)


def test_fused_adaptive_avg_equals_host(mask_setup):
    """Adaptive-Avg's buckets are its pow2 plan space, so the fused run
    equals the host loop's exact plans, bit for bit, and the reference's."""
    task, shards, ttask, tshards = mask_setup
    kw = dict(n_is=N_IS, min_block=32, max_block=512)
    ref, host, fused = _three_runs(
        task, lambda: jreg.bicompfl_spec("GR", allocation=jblocks.AdaptiveAvgAllocation(**kw),
                                         n_is=N_IS, n_dl=N), shards,
        ttask, lambda: treg.bicompfl_spec("GR", allocation=tblocks.AdaptiveAvgAllocation(**kw),
                                          n_is=N_IS, n_dl=N), tshards)
    _assert_identical(host, fused)
    _assert_identical(ref, fused)


@pytest.fixture(scope="module")
def quickstart_setup():
    """The reference's quickstart task at full width (``examples/quickstart.py``:
    10 clients, MLP 100->256->10, d = 28160) and its carriers on the CPU."""
    key = jax.random.PRNGKey(0)
    train, test = make_synthetic(key, n_train=2000, n_test=500, hw=10, noise=0.4)
    shards = partition_iid(jax.random.fold_in(key, 1), train, 10, 200)
    net = make_mlp(in_dim=100, widths=(256,), signed_constant=True)
    task = make_mask_task(net, jax.random.fold_in(key, 2), test.x, test.y,
                          local_epochs=3, lr=0.1)
    ttask = convert.mask_task(task.w0_flat, task.x_test, task.y_test, dims=(100, 256, 10),
                              device="cpu", local_epochs=3, lr=0.1,
                              batch_size=task.batch_size)
    return task, shards, ttask, convert.dataset(shards.x, shards.y, "cpu")


def test_full_width_default_mode_books_the_references_bits(quickstart_setup):
    """The quickstart's width, GR under AdaptiveAllocation(n_is=64), 4
    rounds, seed 0, ``mode="auto"``: the fused path, 69120 bits (the host
    loop's exact plans book 94320), and every round's bucket, segment ids
    and MRC indices equal to the reference's default run; theta
    bit-identical."""
    task, shards, ttask, tshards = quickstart_setup
    js, ts = _recorded_specs("GR", 64, 10)
    jout = JEngine(task, js).run(shards, rounds=4, seed=0)
    tout = TEngine(ttask, ts).run(tshards, rounds=4, seed=0)
    print(f"buckets {tout['buckets']}, bits {[h['cum_bits'] for h in tout['history']]}, "
          f"acc {[h['acc'] for h in tout['history']]}")
    assert jout["mode"] == tout["mode"] == "fused"
    assert tout["meter"]["total_bits"] == jout["meter"]["total_bits"] == 69120.0
    _assert_adaptive_runs_equal(js, ts, jout, tout)
    host = TEngine(ttask, treg.bicompfl_spec("GR", allocation=tblocks.AdaptiveAllocation(
        n_is=64), n_is=64)).run(tshards, rounds=4, seed=0, mode="host")
    assert host["meter"]["total_bits"] == 94320.0


# ---------------------------------------------------------------------------
# The empty segment 0 of a bucketed plan, through the codec.
# ---------------------------------------------------------------------------


def test_codec_takes_a_device_plan_with_empty_segments():
    """``finalize_plan``'s ids may start at 1 (the first edge at 0) and
    leave trailing segments empty; the codec takes them as an int32 tensor
    without the host check and matches the reference's encoder: indices
    equal outside near-ties, the sample equal."""
    d, nb = 600, 24
    klp = np.full(d, 0.01, np.float32)
    klp[0] = 30.0                 # a spike first: the first edges collapse at 0
    plan = tblocks.AdaptiveAllocation(n_is=16).finalize_plan(
        tblocks.BlockPlan(size=None, n_blocks=nb, seg_ids=None, overhead_bits=0.0),
        {"profile": torch.from_numpy(klp), "total": None}, d)
    seg = plan.seg_ids
    assert int(seg[0]) == 1 and int(plan.billable_blocks) < nb
    with pytest.raises(ValueError):
        tm._validate_seg_ids(seg.numpy())    # the host check would refuse it
    rng = np.random.default_rng(5)
    q = rng.uniform(0.05, 0.95, (4, d)).astype(np.float32)
    p = np.clip(q + 0.1 * rng.standard_normal(q.shape), 0, 1).astype(np.float32)
    k = jax.random.PRNGKey(7)
    sks = jax.random.split(jax.random.PRNGKey(8), 4)
    # Under jit the ids are traced, as in the reference's fused scan, which
    # skips its own host check for them.
    want = jax.jit(lambda sg: jax.vmap(lambda s_, q_, p_: jm.encode_segments(
        k, s_, q_, p_, sg, n_is=16, n_seg=nb))(sks, jnp.asarray(q), jnp.asarray(p)))(
        jnp.asarray(seg.numpy()))
    got = tm.encode_segments(convert.key(k, "cpu"), convert.key(sks, "cpu"),
                             torch.from_numpy(q), torch.from_numpy(p), seg, n_is=16,
                             n_seg=nb)
    ji, ti = np.asarray(want.indices), got.indices.numpy()
    assert (ji == ti).mean() >= 0.99, (ji, ti)
    if (ji == ti).all():
        np.testing.assert_array_equal(got.sample.numpy(), np.asarray(want.sample))


# ---------------------------------------------------------------------------
# Cache, eligibility and entry points.
# ---------------------------------------------------------------------------


def test_second_run_of_a_signature_captures_nothing(mask_setup):
    """A seed replicate and a new dataset of the same shapes reuse the
    program; another round count is another signature."""
    _, _, ttask, tshards = mask_setup
    eng = TEngine(ttask, treg.bicompfl_spec("GR", allocation=tblocks.FixedAllocation(BLOCK),
                                            n_is=N_IS))
    first = eng.run(tshards, rounds=2, seed=1)
    n = eng.fused_capture_count
    assert n == 3                       # the train, the codec and the eval
    again = eng.run(tshards, rounds=2, seed=1)
    eng.run(tshards._replace(x=tshards.x.flip(1)), rounds=2, seed=2)
    assert eng.fused_capture_count == n
    _assert_identical(first, again)
    eng.run(tshards, rounds=3, seed=1)
    assert eng.fused_capture_count == 2 * n
    alloc = tblocks.AdaptiveAllocation(n_is=N_IS, target_ratio=0.02)
    eng = TEngine(ttask, treg.bicompfl_spec("GR", allocation=alloc, n_is=N_IS))
    out = eng.run(tshards, rounds=3, seed=SEED)
    assert eng.fused_capture_count == 2 + len(set(out["buckets"]))   # stats, eval, buckets
    eng.run(tshards, rounds=3, seed=SEED)
    assert eng.fused_capture_count == 2 + len(set(out["buckets"]))


def test_fused_mode_raises_where_the_reference_raises(mask_setup):
    """Only non-functional channels, an allocation without a static plan or
    the bucket API, or an adaptive plan with an EF flush keep the host
    loop; ``mode="fused"`` raises the reference's ValueError there and
    ``mode="auto"`` runs the host loop."""
    task, shards, ttask, tshards = mask_setup

    class LegacyOnlyDownlink:
        broadcast_shareable = True

        def distribute(self, ctx, update, theta, theta_hat):
            raise NotImplementedError

    class NoBucketAdaptive:
        static_plan = False
        needs_kl = True

        def plan(self, kl, d):
            return BLOCK, -(-d // BLOCK), None, 0.0

    def cases(reg, blocks):
        legacy = reg.bicompfl_spec("GR", allocation=blocks.FixedAllocation(BLOCK), n_is=N_IS)
        legacy.downlink = LegacyOnlyDownlink()
        nobucket = reg.bicompfl_spec("GR", allocation=blocks.FixedAllocation(BLOCK), n_is=N_IS)
        nobucket.allocation = NoBucketAdaptive()
        flushed = reg.bicompfl_spec("GR", allocation=blocks.AdaptiveAllocation(n_is=N_IS),
                                    n_is=N_IS)
        flushed.sync_period = 2
        return legacy, nobucket, flushed

    for jspec, tspec in zip(cases(jreg, jblocks), cases(treg, tblocks)):
        assert not JEngine(task, jspec).fused_supported()
        assert not TEngine(ttask, tspec).fused_supported()
        with pytest.raises(ValueError) as jerr:
            JEngine(task, jspec).run(shards, rounds=1, seed=1, mode="fused")
        with pytest.raises(ValueError) as terr:
            TEngine(ttask, tspec).run(tshards, rounds=1, seed=1, mode="fused")
        assert str(terr.value) == str(jerr.value)
    _, nobucket, flushed = cases(treg, tblocks)
    assert TEngine(ttask, nobucket).run(tshards, rounds=1, seed=1)["mode"] == "host"
    assert TEngine(ttask, flushed).run(tshards, rounds=1, seed=1)["mode"] == "host"
    for name, kind, fac in T_SCHEMES:       # every registry scheme is eligible
        assert TEngine(ttask, fac()).fused_supported(), name


def test_run_spec_is_a_one_shot_engine(mask_setup):
    _, _, ttask, tshards = mask_setup
    spec = treg.bicompfl_spec("GR", allocation=tblocks.FixedAllocation(BLOCK), n_is=N_IS)
    a = run_spec(ttask, spec, tshards, rounds=2, seed=3, mode="host")
    b = TEngine(ttask, spec).run(tshards, rounds=2, seed=3, mode="host")
    _assert_identical(b, a)
    assert run_spec(ttask, spec, tshards, rounds=1)["mode"] == "fused"


_QUICKSTART_ALLOCATIONS = {"fixed": lambda: jblocks.FixedAllocation(128),
                           "adaptive-avg": lambda: jblocks.AdaptiveAvgAllocation(n_is=64),
                           "adaptive": lambda: jblocks.AdaptiveAllocation(n_is=64)}


@pytest.mark.parametrize("allocation", list(_QUICKSTART_ALLOCATIONS))
def test_quickstart_books_the_references_default_bpp(quickstart_setup, allocation):
    """The CPU entry point at full width, 6 rounds, default mode, against
    the reference's ``FLEngine.run`` in its default (fused) mode on the same
    configuration: the same bpp, exactly (under ``adaptive`` the host loop's
    exact plans would book 0.0724, the bucketed plans 0.0511)."""
    task, shards, _, _ = quickstart_setup
    jspec = jreg.bicompfl_spec("GR", allocation=_QUICKSTART_ALLOCATIONS[allocation](), n_is=64,
                               n_dl=10)
    jout = JEngine(task, jspec).run(shards, rounds=6, seed=0, eval_every=3)
    out = quickstart.run("cpu", rounds=6, cfg={"allocation": allocation})
    print(f"{allocation}: bpp {out['meter']['bpp']} (reference {jout['meter']['bpp']})")
    assert jout["mode"] == out["mode"] == "fused"
    assert out["meter"]["bpp"] == jout["meter"]["bpp"]
    assert math.isfinite(out["final_acc"]) and out["final_acc"] >= 0.9
