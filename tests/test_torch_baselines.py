"""The port's conventional-FL baselines against the reference, on the CPU.

Covers the baselines' channels step by step with their states carried over
three steps (``SignEFChannel`` with one and two passes on both links,
``TopKEFChannel``, ``DenseChannel``, ``SliceDownlink``), the refusal of
partial cohorts by the error-feedback uplinks, the engine's periodic EF
flush (``sync_period``), whole runs of every scheme of ``ALL_BASELINES``
engine against engine (the reference in host mode), ``run_baseline``,
``registry.all_schemes`` and ``data.partition_dirichlet``.  Bits and the
meter must match exactly; signs and top-k sets outside a stated margin;
floats within the tolerance stated where it is used.  No baseline reaches
a kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import channels as jch
from repro.fl import registry as jreg
from repro.fl.baselines import BaselineConfig as JBaselineConfig, run_baseline as j_run_baseline
from repro.fl.data import (make_synthetic as j_make_synthetic, partition_dirichlet as j_dirichlet,
                           partition_iid as j_partition)
from repro.fl.engine import FLEngine as JEngine
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.tasks import make_cfl_task as j_make_cfl_task
from repro_torch import convert
from repro_torch.fl import channels as tch
from repro_torch.fl import registry as treg
from repro_torch.fl.baselines import BaselineConfig as TBaselineConfig, run_baseline as t_run_baseline
from repro_torch.fl.data import partition_dirichlet as t_dirichlet
from repro_torch.fl.engine import FLEngine as TEngine
from repro_torch.kernels import ops

HW, WIDTH, N_CLIENTS, SHARD = 6, 32, 5, 80
DIMS = (HW * HW, WIDTH, 10)                     # d = 36*32 + 32*10 = 1472
ROUNDS, PERIOD = 3, 2                            # CSER and LIEC flush after round 2
# Sign compression scales by mean|v| over d entries, summed in torch's
# order and in XLA's (a few ulp apart).  A compressed vector and the EF
# state it leaves are held to this relative bound of the scale; measured
# <= 5.9e-7 of the scale over three steps of one and of two passes.
SCALE_RTOL = 2e-6
# A sign (or a top-k membership) may differ only where the reference's
# value is within this many scales of the decision point: the inputs of
# steps 2-3 carry the ulp-level differences of the EF state.
SIGN_MARGIN = 1e-5
# Whole runs: dense training through another matmul order and the scales'
# sums; measured max |theta_port - theta_ref| 6e-8 after 3 rounds.
THETA_ATOL = 1e-6
ACC_BAND = 0.02


# ---------------------------------------------------------------------------
# Channels step by step.
# ---------------------------------------------------------------------------


def _ctxs(n, d, active=None):
    active = np.arange(n) if active is None else np.asarray(active)
    kt = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jctx = jch.RoundContext(t=0, key=kt, n_clients=n, d=d, active=active)
    tctx = tch.RoundContext(t=0, key=convert.key(kt, "cpu"), n_clients=n, d=d, active=active,
                            plan=None)
    return jctx, tctx


def _payloads(seed, shape, steps=3):
    rng = np.random.default_rng(seed)
    out = (0.01 * rng.standard_normal((steps,) + shape)).astype(np.float32)
    out[..., 5] = 0.0                               # zeros map to +1
    out[..., 9] = out[..., 10] = 0.004              # tied magnitudes
    return out


def _assert_signs_close(got, want, scale, what):
    """Equal signs outside SIGN_MARGIN scales of zero; values within
    SCALE_RTOL of the scale."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.broadcast_to(np.asarray(scale), want.shape)
    sure = np.abs(want) > SIGN_MARGIN * scale
    np.testing.assert_array_equal(np.sign(got)[sure], np.sign(want)[sure], err_msg=what)
    np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                               atol=SCALE_RTOL * float(scale.max()), err_msg=what)


@pytest.mark.parametrize("passes", [1, 2])
def test_sign_ef_uplink_matches_reference_over_three_steps(passes):
    n, d = 5, 1001
    jctx, tctx = _ctxs(n, d)
    jc, tc = jch.SignEFChannel(passes=passes), tch.SignEFChannel(passes=passes)
    step = jax.jit(lambda e, p: jc.step_up(jctx, e, p, None)[::2])
    je, te = jc.init_up_state(n, d), tc.init_up_state(n, d, "cpu")
    assert te.shape == (n, d) and te.dtype == torch.float32 and not te.any()
    for k, p in enumerate(_payloads(passes, (n, d))):
        (jout, je) = step(je, jnp.asarray(p))
        tout, bits, te = tc.step_up(tctx, te, torch.tensor(p), None)
        assert bits == n * passes * (d + 32)
        scale = np.abs(np.asarray(jout)).max(-1, keepdims=True)
        _assert_signs_close(tout.numpy(), jout, scale, f"step {k} output")
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                                   atol=SCALE_RTOL * float(scale.max()),
                                   err_msg=f"step {k} state")
        if passes == 1:
            assert len(np.unique(np.abs(tout.numpy()[0]))) == 1
            if k == 0:                                          # a zero maps to +1
                np.testing.assert_array_equal(tout.numpy()[:, 5] > 0, True)


@pytest.mark.parametrize("passes,lr,delta", [(1, 1.0, True), (2, 0.5, True), (1, 1.0, False)])
def test_sign_ef_downlink_matches_reference_over_three_steps(passes, lr, delta):
    """The server-side EF memory (d,) steps the server and every client with
    the compressed aggregate; without ``update.delta`` it is recovered as
    ``(theta - update.theta) / lr``."""
    n, d = 5, 1001
    jctx, tctx = _ctxs(n, d)
    jc, tc = jch.SignEFChannel(passes=passes), tch.SignEFChannel(passes=passes)
    rng = np.random.default_rng(7)
    theta = rng.standard_normal(d).astype(np.float32)
    hat = np.tile(theta, (n, 1)) + 0.001 * rng.standard_normal((n, d)).astype(np.float32)

    def jstep(e, th, thh, g):
        upd = jch.ServerUpdate(theta=th - lr * g, delta=g if delta else None, lr=lr)
        res, e = jc.step_down(jctx, e, upd, th, thh)
        return res.theta, res.theta_hat, e

    jstep = jax.jit(jstep)
    je, te = jc.init_down_state(n, d), tc.init_down_state(n, d, "cpu")
    assert te.shape == (d,) and not te.any()
    jth, jhat, tth, that = jnp.asarray(theta), jnp.asarray(hat), torch.tensor(theta), \
        torch.tensor(hat)
    for k, g in enumerate(_payloads(passes + 3, (d,))):
        jth, jhat, je = jstep(je, jth, jhat, jnp.asarray(g))
        tg = torch.tensor(g)
        upd = tch.ServerUpdate(theta=tth - lr * tg, delta=tg if delta else None, lr=lr)
        res, te = tc.step_down(tctx, te, upd, tth, that)
        assert res.bits == n * passes * (d + 32)
        tth, that = res.theta, res.theta_hat
        tol = SCALE_RTOL * float(np.abs(np.asarray(je)).max() + np.abs(g).max()) + 2e-7
        for got, want, what in ((tth, jth, "theta"), (that, jhat, "theta_hat"),
                                (te, je, "state")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol,
                                       err_msg=f"step {k} {what}")


def test_topk_ef_uplink_matches_reference_over_three_steps():
    """No mean, no rounding: the kept entries, the output and the EF state
    are the reference's bit for bit, ties (equal magnitudes) included."""
    n, d, k = 5, 1001, 200
    jctx, tctx = _ctxs(n, d)
    jc, tc = jch.TopKEFChannel(k=k), tch.TopKEFChannel(k=k)
    step = jax.jit(lambda e, p: jc.step_up(jctx, e, p, None)[::2])
    je, te = jc.init_up_state(n, d), tc.init_up_state(n, d, "cpu")
    for s, p in enumerate(_payloads(11, (n, d))):
        p = np.round(p, 3)                                   # many ties at the k-th place
        jout, je = step(je, jnp.asarray(p))
        tout, bits, te = tc.step_up(tctx, te, torch.tensor(p), None)
        assert bits == n * k * (32 + 10)
        assert (tout != 0).sum(-1).max() <= k
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout), err_msg=f"step {s}")
        np.testing.assert_array_equal(te.numpy(), np.asarray(je), err_msg=f"step {s}")
    r, bits, z = tc.flush_step(te, n, d)
    jr, jbits, jz = jc.flush_step(je, n, d)
    assert bits == jbits == n * d * 32 and not z.any() and z.shape == (n, d)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_dense_and_slice_channels_match_reference():
    n, d = 5, 1003
    jctx, tctx = _ctxs(n, d)
    rng = np.random.default_rng(2)
    p = rng.standard_normal((n, d)).astype(np.float32)
    th = rng.standard_normal(d).astype(np.float32)
    hat = rng.standard_normal((n, d)).astype(np.float32)
    dense = tch.DenseChannel()
    out, bits, st = dense.step_up(tctx, dense.init_up_state(n, d, "cpu"), torch.tensor(p), None)
    jout, jbits, _ = jch.DenseChannel().step_up(jctx, (), jnp.asarray(p), None)
    assert bits == jbits == n * d * 32 and st == tch.EMPTY_STATE
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    res = dense.distribute(tctx, tch.ServerUpdate(theta=torch.tensor(th)), None, None)
    jres = jch.DenseChannel().distribute(jctx, jch.ServerUpdate(theta=jnp.asarray(th)),
                                         None, None)
    assert res.bits == jres.bits == n * d * 32
    np.testing.assert_array_equal(res.theta_hat.numpy(), np.asarray(jres.theta_hat))
    assert dense.flush_step((), n, d) == jch.DenseChannel().flush_step((), n, d) == \
        (0.0, n * d * 32, ())
    for k in (1, 7, d // n):
        res = tch.SliceDownlink(k=k).distribute(tctx, tch.ServerUpdate(theta=torch.tensor(th)),
                                               None, torch.tensor(hat))
        jres = jch.SliceDownlink(k=k).distribute(jctx, jch.ServerUpdate(theta=jnp.asarray(th)),
                                                 None, jnp.asarray(hat))
        assert res.bits == jres.bits == n * (d / n) * 32
        np.testing.assert_array_equal(res.theta_hat.numpy(), np.asarray(jres.theta_hat))
        np.testing.assert_array_equal(res.theta.numpy(), th)
        np.testing.assert_array_equal(res.theta_hat.numpy()[-1, (n - 1) * k:],
                                      th[(n - 1) * k:])               # the last slice runs to d
    assert not tch.SliceDownlink(k=1).broadcast_shareable


def test_error_feedback_uplinks_refuse_a_partial_cohort():
    n, d = 5, 64
    jctx, tctx = _ctxs(n, d, active=[0, 2, 4])
    p = np.zeros((3, d), np.float32)
    for jc, tc in ((jch.SignEFChannel(), tch.SignEFChannel()),
                   (jch.TopKEFChannel(k=4), tch.TopKEFChannel(k=4))):
        with pytest.raises(ValueError, match="full participation"):
            jc.step_up(jctx, jnp.zeros((n, d)), jnp.asarray(p), None)
        with pytest.raises(ValueError, match="full participation"):
            tc.step_up(tctx, torch.zeros(n, d), torch.tensor(p), None)


def test_sign_ef_flush_is_the_reference_sync():
    n, d = 5, 300
    e = _payloads(3, (n, d))[0]
    for state in (e, e[0]):                                 # uplink (n, d), downlink (d,)
        r, bits, z = tch.SignEFChannel().flush_step(torch.tensor(state), n, d)
        jr, _ = jax.jit(lambda s: jch.SignEFChannel().flush_step(s, n, d)[::2])(
            jnp.asarray(state))
        assert bits == jch.SignEFChannel().flush_step(jnp.asarray(state), n, d)[1] == n * d * 32
        assert z.shape == state.shape and not z.any()
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# Whole runs, engine against engine.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    key = jax.random.PRNGKey(0)
    train, test = j_make_synthetic(key, n_train=400, n_test=100, hw=HW, noise=0.4)
    shards = j_partition(jax.random.fold_in(key, 1), train, N_CLIENTS, SHARD)
    task, theta0 = j_make_cfl_task(j_make_mlp(HW * HW, (WIDTH,)), jax.random.fold_in(key, 2),
                                   test.x, test.y, local_epochs=2, batch_size=32,
                                   local_lr=3e-3)
    ttask, ttheta0 = convert.cfl_task(theta0, test.x, test.y, dims=DIMS, device="cpu",
                                      local_epochs=2, batch_size=32, local_lr=3e-3)
    return {"train": train, "shards": shards, "task": task, "theta0": theta0,
            "ttask": ttask, "ttheta0": ttheta0,
            "tshards": convert.dataset(shards.x, shards.y, "cpu")}


def _assert_runs_close(jout, tout):
    assert [h["cum_bits"] for h in tout["history"]] == [h["cum_bits"] for h in jout["history"]]
    assert tout["meter"] == jout["meter"]
    for key in ("theta", "theta_hat"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=THETA_ATOL, rtol=0, err_msg=key)
    for jh, th in zip(jout["history"], tout["history"]):
        assert abs(jh["acc"] - th["acc"]) <= ACC_BAND, (jh, th)


@pytest.mark.parametrize("scheme", treg.ALL_BASELINES)
def test_baseline_run_matches_reference(ref, scheme):
    """3 rounds, 5 clients, CSER and LIEC flushing after round 2: bits and
    the meter equal every round, theta and theta_hat within THETA_ATOL,
    accuracy within ACC_BAND; no kernel is launched."""
    d = ref["task"].d
    jspec = jreg.baseline_spec(scheme, n=N_CLIENTS, d=d, reset_period=PERIOD)
    tspec = treg.baseline_spec(scheme, n=N_CLIENTS, d=d, reset_period=PERIOD)
    assert tspec.name == jspec.name and tspec.sync_period == jspec.sync_period
    for role in ("uplink", "downlink", "aggregator"):
        assert type(getattr(tspec, role)).__name__ == type(getattr(jspec, role)).__name__
    jout = JEngine(ref["task"], jspec).run(ref["shards"], ref["theta0"], rounds=ROUNDS,
                                           seed=0, eval_every=1, mode="host")
    before = ops.mrc_logw.launches
    tout = TEngine(ref["ttask"], tspec).run(ref["tshards"], ref["ttheta0"], rounds=ROUNDS,
                                            seed=0, eval_every=1)
    assert ops.mrc_logw.launches == before
    print(f"{scheme}: bits {tout['meter']['total_bits']}, max |theta diff| "
          f"{np.abs(tout['theta'].numpy() - np.asarray(jout['theta'])).max():.3e}")
    _assert_runs_close(jout, tout)
    per_round = np.diff([0.0] + [h["cum_bits"] for h in tout["history"]])
    flush = 2 * N_CLIENTS * d * 32 if scheme in ("cser", "liec") else 0.0
    assert per_round[PERIOD - 1] == per_round[0] + flush         # both links sync


class _LoggedSignEF(tch.SignEFChannel):
    """Records the EF state each uplink step receives."""

    def step_up(self, ctx, e, payload, priors):
        self.log.append(e.clone())
        return super().step_up(ctx, e, payload, priors)


def test_flush_books_its_bits_and_resets_the_states(ref):
    """LIEC with sync period 2 over 3 rounds: round 2 books n*d*32 more bits
    on each link, every client resyncs to theta, and round 3's uplink and
    downlink start from zero EF memories, as in the reference."""
    d = ref["task"].d
    tspec = treg.baseline_spec("liec", n=N_CLIENTS, d=d, reset_period=PERIOD)
    tspec.uplink = _LoggedSignEF()
    tspec.uplink.log = []
    tout = TEngine(ref["ttask"], tspec).run(ref["tshards"], ref["ttheta0"], rounds=ROUNDS,
                                            seed=0)
    jout = JEngine(ref["task"], jreg.baseline_spec("liec", n=N_CLIENTS, d=d,
                                                   reset_period=PERIOD)).run(
        ref["shards"], ref["theta0"], rounds=ROUNDS, seed=0, mode="host")
    sign = N_CLIENTS * (d + 32)
    flush = N_CLIENTS * d * 32
    cum = np.cumsum([2 * sign, 2 * sign + 2 * flush, 2 * sign]).tolist()
    assert [h["cum_bits"] for h in tout["history"]] == cum == \
        [h["cum_bits"] for h in jout["history"]]
    assert not tspec.uplink.log[0].any() and tspec.uplink.log[1].any()
    assert not tspec.uplink.log[2].any()                      # reset by the flush
    np.testing.assert_allclose(tout["theta"].numpy(), np.asarray(jout["theta"]),
                               atol=THETA_ATOL, rtol=0)
    out2 = TEngine(ref["ttask"], treg.baseline_spec("liec", n=N_CLIENTS, d=d,
                                                    reset_period=PERIOD)).run(
        ref["tshards"], ref["ttheta0"], rounds=PERIOD, seed=0)
    th = out2["theta_hat"]
    assert bool((th == out2["theta"][None]).all())           # everyone resynced


def test_run_baseline_matches_reference(ref):
    cfg = dict(scheme="doublesqueeze", rounds=2, server_lr=0.5, eval_every=2)
    jout = j_run_baseline(ref["task"], ref["theta0"], ref["shards"], JBaselineConfig(**cfg))
    tout = t_run_baseline(ref["ttask"], ref["ttheta0"], ref["tshards"], TBaselineConfig(**cfg))
    assert [h["round"] for h in tout["history"]] == [2]
    _assert_runs_close(jout, tout)


# ---------------------------------------------------------------------------
# Registry and data.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("include_adaptive", [False, True])
def test_all_schemes_lists_the_reference_matrix(include_adaptive):
    kw = dict(n=4, d=300, n_is=8, block=32, n_dl=3, server_lr=0.5, reset_period=3,
              include_adaptive=include_adaptive)
    want = jreg.all_schemes(**kw)
    got = treg.all_schemes(**kw)
    assert [(name, kind) for name, kind, _ in got] == [(name, kind) for name, kind, _ in want]
    for (name, _, tf), (_, _, jf) in zip(got, want):
        ts, js = tf(), jf()
        assert ts.name == js.name and ts.sync_period == js.sync_period, name
        assert tf() is not ts and tf().uplink is not ts.uplink    # a fresh spec per call
        for role in ("uplink", "downlink", "aggregator", "allocation"):
            tc, jc = getattr(ts, role), getattr(js, role)
            assert type(tc).__name__ == type(jc).__name__, (name, role)
            if dataclasses.is_dataclass(tc):
                for f in dataclasses.fields(tc):
                    if hasattr(jc, f.name):
                        assert getattr(tc, f.name) == getattr(jc, f.name), (name, role, f.name)


def test_baseline_spec_refuses_unknown_schemes_and_sizes_m3():
    for bad in ("sgd", "bicompfl-gr", ""):
        with pytest.raises(ValueError):
            treg.baseline_spec(bad, n=4, d=10)
    assert treg.baseline_spec("DoubleSqueeze", n=4, d=10).name == "doublesqueeze"
    m3 = treg.baseline_spec("m3", n=7, d=100)
    assert m3.uplink.k == m3.downlink.k == 14
    assert treg.baseline_spec("m3", n=7, d=3).uplink.k == 1
    assert treg.baseline_spec("cser", n=4, d=10).sync_period == 50
    assert treg.baseline_spec("memsgd", n=4, d=10).sync_period == 0


@pytest.mark.parametrize("seed,alpha,n_clients,shard", [(0, 0.1, 5, 80), (1, 1.0, 10, 33),
                                                        (2, 100.0, 3, 200)])
def test_partition_dirichlet_gives_the_reference_shards(ref, seed, alpha, n_clients, shard):
    train = ref["train"]
    key = jax.random.PRNGKey(seed)
    want = j_dirichlet(key, train, n_clients, shard, alpha=alpha)
    got = t_dirichlet(convert.key(key, "cpu"), convert.dataset(train.x, train.y, "cpu"),
                      n_clients, shard, alpha=alpha)
    assert got.x.shape == (n_clients, shard, HW, HW, 1)
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
