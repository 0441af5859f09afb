"""The port's fault injection (``repro_torch.fl.faults`` and the engine's
faulted paths) against the reference's, on the CPU.

* **schedules** -- ``FaultPlan.schedule`` draws the reference's tables
  (hypothesis over rates, seeds and sizes), its round views and flipped
  bits are the reference's, and the CRC catches every single-bit flip;
* **aggregation** -- the survivor-weighted ``_cohort_mean`` is the
  reference's ``tensordot(w, x) / den`` bit for bit on real-valued rows;
* **runs against the reference** -- for each ``fault_matrix`` family under a
  plan that bites (DESIGN.md §8's smoke rates), the port's faulted
  host-loop run and the reference's give equal fault reports, meters and
  histories' bits; ``bicompfl-pr`` is bit-equal in theta and theta_hat and
  its faulted wire session (every MRC index) is the reference's byte for
  byte; the delta families are within ``THETA_ATOL``;
* **within the port** -- faulted host == faulted fused bit for bit, a
  trivial plan == ``faults=None`` for every registry scheme, the all-fail
  round, and the faulted wire audit's retransmit bookings.
"""
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import faults as jfaults
from repro.fl import registry as jreg
from repro.fl.data import make_synthetic, partition_iid
from repro.fl.engine import FLEngine as JEngine, _cohort_mean as j_cohort_mean
from repro.fl.nets import make_mlp
from repro.fl.tasks import make_cfl_task, make_mask_task
from repro_torch import convert
from repro_torch.fl import registry as treg
from repro_torch.fl.engine import FLEngine, _cohort_mean
from repro_torch.fl.faults import FaultPlan, corrupt_copy
from repro_torch.wire import DIR_UP, Message, WireError

N, D = 4, 208
T_MATRIX = treg.fault_matrix(n=N, d=D, n_is=16, block=16, reset_period=2)
J_MATRIX = jreg.fault_matrix(n=N, d=D, n_is=16, block=16, reset_period=2)
FAMILIES = [s[0] for s in T_MATRIX]
T_SCHEMES = treg.all_schemes(n=N, d=D, n_is=16, block=16, reset_period=2)
RATES = dict(drop_rate=0.3, straggler_rate=0.1, corrupt_rate=0.2, seed=5)
PLAN = FaultPlan(**RATES)
J_PLAN = jfaults.FaultPlan(**RATES)
# The delta families' models against the reference's: dense training and
# its Adam sums run in torch's order, a few ulp from XLA's (the tolerance of
# test_torch_baselines.py and test_torch_cfl.py); measured <= 1.2e-7.
THETA_ATOL = 1e-6


@pytest.fixture(scope="module")
def setups():
    k = jax.random.PRNGKey(3)
    train, test = make_synthetic(k, n_train=120, n_test=60, hw=4, noise=0.5)
    shards = partition_iid(jax.random.fold_in(k, 1), train, N, 30)
    mask = make_mask_task(make_mlp(in_dim=16, widths=(8,), signed_constant=True),
                          jax.random.fold_in(k, 2), test.x, test.y, local_epochs=1,
                          batch_size=30)
    tmask = convert.mask_task(mask.w0_flat, mask.x_test, mask.y_test, dims=(16, 8, 10),
                              device="cpu", local_epochs=1, batch_size=30, lr=mask.lr)
    # Several Adam steps: after one, every |delta| is the step size and M3's
    # top-k picks among ties that only rounding tells apart.
    cfl, theta0 = make_cfl_task(make_mlp(in_dim=16, widths=(8,)), jax.random.fold_in(k, 4),
                                test.x, test.y, local_epochs=2, batch_size=10,
                                local_lr=3e-3)
    assert int(theta0.shape[0]) == D
    tcfl, ttheta0 = convert.cfl_task(theta0, cfl.x_test, cfl.y_test, dims=(16, 8, 10),
                                     device="cpu", local_epochs=2, batch_size=10,
                                     local_lr=3e-3)
    return {"mask": ((mask, None), (tmask, None)), "delta": ((cfl, theta0), (tcfl, ttheta0)),
            "shards": shards, "tshards": convert.dataset(shards.x, shards.y, "cpu")}


def _port(setups, kind):
    task, theta0 = setups[kind][1]
    return task, setups["tshards"], theta0


def _assert_identical(a, b):
    assert len(a["history"]) == len(b["history"])
    for ha, hb in zip(a["history"], b["history"]):
        assert ha == hb
    assert a["meter"] == b["meter"]
    assert torch.equal(a["theta"], b["theta"])
    assert torch.equal(a["theta_hat"], b["theta_hat"])


# ---------------------------------------------------------------------------
# Schedules (pure numpy).
# ---------------------------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(st.floats(min_value=0.0, max_value=0.95), st.floats(min_value=0.0, max_value=0.95),
       st.floats(min_value=0.0, max_value=0.9), st.integers(min_value=0, max_value=10_000),
       st.integers(min_value=1, max_value=6), st.integers(min_value=1, max_value=7),
       st.integers(min_value=0, max_value=4))
def test_schedule_draws_the_references_tables(dr, sr, cr, seed, rounds, n, retries):
    kw = dict(drop_rate=dr, straggler_rate=sr, corrupt_rate=cr, seed=seed, max_retries=retries)
    got, want = FaultPlan(**kw).schedule(rounds, n), jfaults.FaultPlan(**kw).schedule(rounds, n)
    for field in ("drop", "straggle", "up_failures", "dn_failures", "flip_u"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    rng = np.random.default_rng(seed)
    cohort = np.stack([np.sort(rng.choice(n, size=max(1, n - 1), replace=False))
                       for _ in range(rounds)])
    for rec in ("all", "active"):
        for g, w in zip(got.run_views(cohort, rec), want.run_views(cohort, rec)):
            assert g.event(1.5) == w.event(1.5)
            assert (g.faulty, g.all_failed) == (w.faulty, w.all_failed)
            for field in ("delivered_up", "contrib", "up_wasted", "delivered_dn", "dn_wasted",
                          "up_weight"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    assert got.flip_bit(0, 0, 1, retries, 1000) == want.flip_bit(0, 0, 1, retries, 1000)
    assert FaultPlan(**kw).trivial == jfaults.FaultPlan(**kw).trivial


def test_plan_validation_is_the_references():
    for bad in (dict(drop_rate=1.0), dict(corrupt_rate=-0.1), dict(max_retries=-1),
                dict(backoff_factor=0.5)):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan(**bad)


def test_crc_catches_every_single_bit_flip():
    m = Message(direction=DIR_UP, sender=2, recipient=0xFFFF, payload=b"\xa5\x5a\xf0",
                payload_bits=20, round=9, scheme_id=0xBEEF)
    raw = m.to_bytes()
    assert Message.from_bytes(raw).payload_bits == 20
    for bitpos in range(8 * len(raw)):
        bad = corrupt_copy(raw, bitpos)
        assert bad == jfaults.corrupt_copy(raw, bitpos) != raw
        with pytest.raises(WireError):
            Message.from_bytes(bad)


# ---------------------------------------------------------------------------
# The survivor-weighted cohort mean.
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self, w):
        self.up_weight = w


@pytest.mark.parametrize("n,d", [(2, 33), (4, 208), (5, 1001), (10, 1472)])
def test_weighted_cohort_mean_is_the_references(n, d):
    rng = np.random.default_rng(n * d)
    for trial in range(4):
        x = (rng.standard_normal((n, d)) * rng.uniform(1e-3, 10)).astype(np.float32)
        w = (rng.random(n) < 0.6).astype(np.float32)
        if trial == 3:
            w[:] = 0.0                     # all-fail: guarded, finite
        want = np.asarray(j_cohort_mean(_Ctx(jnp.asarray(w)), jnp.asarray(x)))
        got = _cohort_mean(_Ctx(torch.tensor(w)), torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert torch.equal(_cohort_mean(_Ctx(None), torch.tensor(x)),
                       torch.tensor(np.asarray(jnp.mean(jnp.asarray(x), axis=0))))


# ---------------------------------------------------------------------------
# Faulted runs against the reference.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _family_runs(name, key):
    """(reference host, port host, port fused) faulted 4-round runs of one
    fault_matrix family, computed once per module."""
    setups = _SETUPS[key]
    i = FAMILIES.index(name)
    kind = T_MATRIX[i][1]
    (jtask, jtheta0), (ttask, ttheta0) = setups[kind]
    kw = dict(rounds=4, seed=7)
    ref = JEngine(jtask, J_MATRIX[i][2]()).run(setups["shards"], jtheta0, mode="host",
                                               faults=J_PLAN, **kw)
    host = FLEngine(ttask, T_MATRIX[i][2]()).run(setups["tshards"], ttheta0, mode="host",
                                                 faults=PLAN, **kw)
    fused = FLEngine(ttask, T_MATRIX[i][2]()).run(setups["tshards"], ttheta0, mode="fused",
                                                  faults=PLAN, **kw)
    return ref, host, fused


_SETUPS = {}


def _runs(name, setups):
    _SETUPS[id(setups)] = setups
    return _family_runs(name, id(setups))


@pytest.mark.parametrize("name", FAMILIES)
def test_faulted_host_run_matches_the_reference(name, setups):
    ref, host, _ = _runs(name, setups)
    assert host["faults"] == ref["faults"]
    assert ref["faults"]["summary"]["faulty_rounds"] > 0        # the plan bites
    assert host["meter"] == ref["meter"]
    assert [h["cum_bits"] for h in host["history"]] == [h["cum_bits"] for h in ref["history"]]
    np.testing.assert_array_equal(host["active_schedule"], ref["active_schedule"])
    if T_MATRIX[FAMILIES.index(name)][1] == "mask":
        np.testing.assert_array_equal(host["theta"].numpy(), np.asarray(ref["theta"]))
        np.testing.assert_array_equal(host["theta_hat"].numpy(), np.asarray(ref["theta_hat"]))
        assert host["history"] == ref["history"]
    else:
        for key in ("theta", "theta_hat"):
            np.testing.assert_allclose(host[key].numpy(), np.asarray(ref[key]),
                                       atol=THETA_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", FAMILIES)
def test_faulted_fused_run_is_the_host_run(name, setups):
    _, host, fused = _runs(name, setups)
    assert (host["mode"], fused["mode"]) == ("host", "fused")
    _assert_identical(host, fused)
    assert host["faults"] == fused["faults"]
    assert host["meter"]["retransmit_bits"] == \
        host["faults"]["summary"]["retransmit_bits_total"]


def test_faulted_pr_wire_session_is_the_references(setups):
    """Every MRC index, CTRL copy and delivered frame of a faulted PR run:
    the port's audited session is the reference's byte for byte, and the
    wasted (corrupted) copies are the same frames with the same flipped
    bits."""
    (jtask, _), (ttask, _) = setups["mask"]
    kw = dict(rounds=3, seed=7, mode="host", wire="audit")
    want = JEngine(jtask, J_MATRIX[0][2]()).run(setups["shards"], faults=J_PLAN, **kw)
    got = FLEngine(ttask, T_MATRIX[0][2]()).run(setups["tshards"], faults=PLAN, **kw)
    assert got["wire_session"].to_bytes() == want["wire_session"].to_bytes()
    assert [(w.round, w.attempt, w.flipped_bit, w.frame.to_bytes())
            for w in got["wire_session"].wasted] == \
        [(w.round, w.attempt, w.flipped_bit, w.frame.to_bytes())
         for w in want["wire_session"].wasted]
    assert got["wire"] == want["wire"] and got["meter"] == want["meter"]
    assert got["faults"] == want["faults"]
    np.testing.assert_array_equal(got["theta_hat"].numpy(), np.asarray(want["theta_hat"]))


# ---------------------------------------------------------------------------
# Within the port.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["host", "fused"])
@pytest.mark.parametrize("name,kind,factory", T_SCHEMES, ids=[s[0] for s in T_SCHEMES])
def test_trivial_plan_bit_identical(setups, name, kind, factory, mode):
    task, shards, theta0 = _port(setups, kind)
    base = FLEngine(task, factory()).run(shards, theta0, rounds=2, seed=7, mode=mode)
    triv = FLEngine(task, factory()).run(shards, theta0, rounds=2, seed=7, mode=mode,
                                         faults=FaultPlan(seed=99))
    _assert_identical(base, triv)
    assert triv["faults"]["summary"]["faulty_rounds"] == 0
    assert triv["faults"]["events"] == []
    assert "faults" not in base


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_all_fail_rounds_keep_the_model(setups, mode):
    """Every client offline every round: each round aborts, the model never
    moves, no downlink bits are billed, host and fused alike."""
    task, shards, _ = _port(setups, "mask")
    seed = next(s for s in range(1000)
                if FaultPlan(drop_rate=0.95, seed=s).schedule(2, N).drop.all())
    out = FLEngine(task, T_MATRIX[0][2]()).run(shards, rounds=2, seed=7, mode=mode,
                                               faults=FaultPlan(drop_rate=0.95, seed=seed))
    rep = out["faults"]
    assert rep["summary"]["all_failed_rounds"] == 2
    assert all(e["all_failed"] and e["survivors"] == 0 for e in rep["events"])
    assert out["meter"]["downlink_bpp"] == 0.0
    assert torch.equal(out["theta"], task.init_theta())
    assert len({h["acc"] for h in out["history"]}) == 1


@pytest.mark.parametrize("name", ["bicompfl-pr", "doublesqueeze"])
def test_faulted_wire_audit_reconciles_and_matches_booking(setups, name):
    i = FAMILIES.index(name)
    task, shards, theta0 = _port(setups, T_MATRIX[i][1])
    kw = dict(rounds=3, seed=7, mode="host", faults=PLAN)
    wired = FLEngine(task, T_MATRIX[i][2]()).run(shards, theta0, wire="audit", **kw)
    rep = wired["wire"]       # reconcile raises on any divergence
    assert rep["retransmit_err_bits"] == 0.0 and rep["retransmit_stream_bits"] > 0
    assert wired["meter"]["retransmit_bits"] == \
        wired["wire_session"].retransmit_payload_bits
    assert wired["meter"]["retransmit_bits"] == \
        wired["faults"]["summary"]["retransmit_bits_total"]
    plain = FLEngine(task, T_MATRIX[i][2]()).run(shards, theta0, **kw)
    assert plain["meter"]["retransmit_bits"] == pytest.approx(
        wired["meter"]["retransmit_bits"])
    assert plain["faults"]["summary"]["retransmits_total"] == \
        wired["faults"]["summary"]["retransmits_total"]
    assert torch.equal(plain["theta"], wired["theta"])
    assert torch.equal(plain["theta_hat"], wired["theta_hat"])


def test_fault_arguments_are_refused_as_the_reference_refuses(setups):
    task, shards, _ = _port(setups, "mask")
    eng = FLEngine(task, T_MATRIX[0][2]())
    with pytest.raises(ValueError, match="expected a FaultPlan"):
        eng.run(shards, rounds=1, faults=J_PLAN)
    with pytest.raises(ValueError, match="checkpoint_every needs checkpoint_dir"):
        eng.run(shards, rounds=1, checkpoint_every=2)
    with pytest.raises(ValueError, match="< 0"):
        eng.run(shards, rounds=1, checkpoint_dir="unused", checkpoint_every=-1)
