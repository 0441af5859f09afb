"""The port's BiCompFL-GR slice end to end against the reference, on the CPU.

Inputs are carried across with ``repro_torch.convert`` (or regenerated from
the same seed, where the port's generator is bit-exact), so both packages
compute the same thing.  Integers (indices, labels, partitions, bits) must
match exactly; floats within a tolerance stated where it is used.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocks import FixedAllocation as JFixed
from repro.fl import channels as jch
from repro.fl.data import make_synthetic as j_make_synthetic, partition_iid as j_partition
from repro.fl.engine import FLEngine as JEngine, MeanModelAggregator as JMean
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.registry import bicompfl_spec as j_spec
from repro.fl.tasks import make_mask_task as j_make_task
from repro import optim as j_optim
from repro_torch import convert, prng
from repro_torch import optim as t_optim
from repro_torch.core.blocks import (AdaptiveAllocation as TAdaptive,
                                     AdaptiveAvgAllocation as TAdaptiveAvg, BlockPlan,
                                     FixedAllocation as TFixed)
from repro_torch.fl import channels as tch
from repro_torch.fl.data import make_synthetic as t_make_synthetic, partition_iid as t_partition
from repro_torch.fl.engine import FLEngine as TEngine, MeanModelAggregator as TMean
from repro_torch.fl.faults import FaultPlan
from repro_torch.fl.nets import flatten_weights, make_mlp as t_make_mlp
from repro_torch.fl.registry import bicompfl_spec as t_spec

REPO = Path(__file__).resolve().parents[1]
HW, WIDTH, N_CLIENTS, SHARD = 6, 32, 5, 80
DIMS = (HW * HW, WIDTH, 10)                     # d = 36*32 + 32*10 = 1472
BLOCK, N_IS = 64, 16
# local_train: same w0, data, keys; float32 forward/backward in another op
# order.  Measured max |q_port - q_ref| is 6.6e-6 on this task, at one of
# 7360 entries; every other entry is within 1e-6.
Q_ATOL = 1e-5
# Accuracy of the same theta on 100 test points, computed in another op
# order: one point may fall on the other side of an argmax.
ACC_BAND = 0.02


@pytest.fixture(scope="module")
def ref():
    key = jax.random.PRNGKey(0)
    train, test = j_make_synthetic(key, n_train=400, n_test=100, hw=HW, noise=0.4)
    shards = j_partition(jax.random.fold_in(key, 1), train, N_CLIENTS, SHARD)
    net = j_make_mlp(HW * HW, (WIDTH,), signed_constant=True)
    task = j_make_task(net, jax.random.fold_in(key, 2), test.x, test.y,
                       local_epochs=2, lr=0.1, batch_size=64)
    return {"key": key, "train": train, "test": test, "shards": shards, "task": task}


def _port_task(ref):
    t = ref["task"]
    return convert.mask_task(t.w0_flat, t.x_test, t.y_test, dims=DIMS, device="cpu",
                             local_epochs=t.local_epochs, lr=t.lr,
                             batch_size=t.batch_size)


def _port_shards(ref):
    return convert.dataset(ref["shards"].x, ref["shards"].y, "cpu")


def test_synthetic_data_and_partition_match_reference(ref):
    """Labels and partitions are exact (threefry ints); pixels pass through
    ``erfinv`` and a box filter summed in another order (float tolerance)."""
    tkey = prng.PRNGKey(0, device="cpu")
    train, test = t_make_synthetic(tkey, n_train=400, n_test=100, hw=HW, noise=0.4,
                                   device="cpu")
    np.testing.assert_array_equal(train.y.numpy(), np.asarray(ref["train"].y))
    np.testing.assert_array_equal(test.y.numpy(), np.asarray(ref["test"].y))
    np.testing.assert_allclose(train.x.numpy(), np.asarray(ref["train"].x), atol=2e-5)
    shards = t_partition(prng.fold_in(tkey, 1), train, N_CLIENTS, SHARD)
    np.testing.assert_array_equal(shards.y.numpy(), np.asarray(ref["shards"].y))


def test_signed_constant_init_is_bit_exact(ref):
    net = t_make_mlp(HW * HW, (WIDTH,), signed_constant=True, device="cpu")
    w0_flat, unravel = flatten_weights(
        net.init(prng.fold_in(prng.PRNGKey(0, device="cpu"), 2)))
    np.testing.assert_array_equal(w0_flat.numpy(), np.asarray(ref["task"].w0_flat))
    back = torch.cat([w.reshape(-1) for w in unravel(w0_flat)])
    np.testing.assert_array_equal(back.numpy(), w0_flat.numpy())


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_steps_match_reference(name):
    """Five steps on the same gradients: the same float32 expressions in the
    same order (Adam's bias corrections included) and a correctly rounded
    sqrt on both sides, so the same bits."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(257).astype(np.float32)
    grads = rng.standard_normal((5, 257)).astype(np.float32)
    jopt, topt = getattr(j_optim, name)(0.1), getattr(t_optim, name)(0.1)
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jnp.asarray(g), jp, js)
        tp, ts = topt.update(torch.tensor(g), tp, ts)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_local_train_matches_reference(ref):
    """Same theta, shards and keys: posteriors agree to ``Q_ATOL``.

    Also counts the STE mask draws that flipped: at each step k the mask is
    ``u_k < sigma(s_k)`` with the reference's u_k (bit-exact here).  The
    threefry streams are prefix-consistent, so a run of k steps (one epoch
    per step here) yields each package's ``clip01(sigma(s_k))``.
    """
    task, ttask = ref["task"], _port_task(ref)
    sh, tsh = ref["shards"], _port_shards(ref)
    theta = np.random.default_rng(0).uniform(0.2, 0.8, (N_CLIENTS, task.d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), N_CLIENTS)
    tkeys = convert.key(keys, "cpu")

    def both(epochs):
        jt = dataclasses.replace(task, local_epochs=epochs)
        tt = dataclasses.replace(ttask, local_epochs=epochs)
        q = np.asarray(jax.vmap(jt.local_train)(jnp.asarray(theta), sh.x, sh.y, keys))
        tq = tt.local_train(torch.tensor(theta), tsh.x, tsh.y, tkeys).numpy()
        return q, tq

    q, tq = both(2)
    print(f"local_train max |q_port - q_ref|: {np.abs(tq - q).max():.3e}")
    np.testing.assert_allclose(tq, q, atol=Q_ATOL, rtol=0)
    # step 0 draws on sigma(inv_sigmoid(theta)); step 1 on a 1-step run's output
    p1, tp1 = both(1)
    km = prng.split(tkeys, 2)[:, 1]
    mks = prng.split(km, 2)
    probs = [(np.asarray(jax.nn.sigmoid(jnp.log(theta) - jnp.log1p(-theta))),
              torch.sigmoid(torch.log(torch.tensor(theta))
                            - torch.log1p(-torch.tensor(theta))).numpy()),
             (p1, tp1)]
    flips = 0
    for k, (pr, pt) in enumerate(probs):
        u = prng.uniform(mks[:, k], (task.d,)).numpy()
        flips += int(((u < pr) != (u < pt)).sum())
    print(f"STE mask draws flipped: {flips} of {2 * theta.size}")
    assert flips <= 2


def _ref_round(ref, q, priors, kt):
    """One reference GR round (uplink -> mean -> index relay), eager."""
    n, d = q.shape
    plan = jch.BlockPlan(size=BLOCK, n_blocks=-(-d // BLOCK), seg_ids=None,
                         overhead_bits=0.0)
    ctx = jch.RoundContext(t=0, key=kt, n_clients=n, d=d, active=np.arange(n),
                           plan=plan)
    up = jch.MRCFixedChannel(n_is=N_IS)
    idxs, q_hat, ul_bits = up._transmit(ctx, jnp.asarray(q), jnp.asarray(priors))
    update = JMean()(ctx, None, q_hat)
    res = jch.IndexRelayDownlink(n_is=N_IS).distribute(ctx, update, None, None)
    return np.asarray(idxs), np.asarray(res.theta), np.asarray(res.theta_hat), ul_bits, res.bits


def _port_round(q, priors, kt):
    n, d = q.shape
    plan = BlockPlan(size=BLOCK, n_blocks=-(-d // BLOCK), seg_ids=None,
                     overhead_bits=0.0)
    ctx = tch.RoundContext(t=0, key=kt, n_clients=n, d=d, active=np.arange(n),
                           plan=plan)
    up = tch.MRCFixedChannel(n_is=N_IS)
    idxs, q_hat, ul_bits = up._transmit(ctx, torch.tensor(q), torch.tensor(priors))
    update = TMean()(ctx, None, q_hat)
    res = tch.IndexRelayDownlink(n_is=N_IS).distribute(ctx, update, None, None)
    return idxs.numpy(), res.theta.numpy(), res.theta_hat.numpy(), ul_bits, res.bits


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 10), (2, 3)])
def test_one_round_is_identical(ref, seed, n):
    """Reference payload and priors: identical indices, bit-identical theta,
    identical bits.  theta is a mean of {0,1} samples, so its only rounding
    is the division by n, which the port does as the reference does (a
    multiply by the float32 reciprocal: 9/10 -> 0.90000004)."""
    rng = np.random.default_rng(seed)
    d = ref["task"].d
    priors = rng.uniform(0.05, 0.95, (n, d)).astype(np.float32)
    q = np.clip(priors + 0.1 * rng.standard_normal(priors.shape), 0, 1).astype(np.float32)
    kt = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    ji, jth, jthh, jul, jdl = _ref_round(ref, q, priors, kt)
    ti, tth, tthh, tul, tdl = _port_round(q, priors, convert.key(kt, "cpu"))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tth.view(np.uint32), jth.view(np.uint32))
    np.testing.assert_array_equal(tthh, jthh)
    assert (tul, tdl) == (jul, jdl)


class _RecordingRef(jch.MRCFixedChannel):
    """Reference uplink that also hands its indices to the host each round."""

    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        jax.debug.callback(lambda i: self.log.append(np.asarray(i)), idxs)
        return q_hat, bits, state


class _RecordingPort(tch.MRCFixedChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append(idxs.numpy())
        return q_hat, bits, state


def test_engine_run_matches_reference(ref):
    """3 rounds of BiCompFL-GR, 5 clients: bits equal every round, >= 99% of
    the MRC indices equal, accuracy within ``ACC_BAND``; with every index
    equal, the model is bit-identical too."""
    task, ttask = ref["task"], _port_task(ref)
    jspec = j_spec("GR", allocation=JFixed(BLOCK), n_is=N_IS)
    tspec = t_spec("GR", allocation=TFixed(BLOCK), n_is=N_IS)
    jspec.uplink = _RecordingRef(n_is=N_IS)
    tspec.uplink = _RecordingPort(n_is=N_IS)
    jspec.uplink.log, tspec.uplink.log = [], []
    jout = JEngine(task, jspec).run(ref["shards"], rounds=3, seed=0, eval_every=1,
                                    mode="host")
    tout = TEngine(ttask, tspec).run(_port_shards(ref), rounds=3, seed=0, eval_every=1)
    assert [h["cum_bits"] for h in tout["history"]] == \
        [h["cum_bits"] for h in jout["history"]]
    assert tout["meter"] == jout["meter"]
    ji, ti = np.stack(jspec.uplink.log), np.stack(tspec.uplink.log)
    rate = float((ji == ti).mean())
    print(f"engine MRC index match rate: {rate:.4f} over {ji.size} indices")
    assert rate >= 0.99
    if rate == 1.0:
        np.testing.assert_array_equal(tout["theta"].numpy(), np.asarray(jout["theta"]))
    for jh, th in zip(jout["history"], tout["history"]):
        assert abs(jh["acc"] - th["acc"]) <= ACC_BAND, (jh, th)


def test_registry_and_engine_refuse_what_is_not_ported(ref, tmp_path):
    for variant in ("PR", "GR-Reconst", "PR-SplitDL"):       # ported since
        assert t_spec(variant, allocation=TFixed(BLOCK)).name == f"BiCompFL-{variant}"
    for alloc in (TAdaptive(n_is=N_IS), TAdaptiveAvg(n_is=N_IS)):   # ported since
        assert t_spec("GR", allocation=alloc, n_is=N_IS).allocation is alloc
    with pytest.raises(ValueError):
        t_spec("nope", allocation=TFixed(BLOCK))
    with pytest.raises(NotImplementedError):
        t_spec("GR", allocation=object())
    eng = TEngine(_port_task(ref), t_spec("GR", allocation=TFixed(BLOCK), n_is=N_IS))
    shards = _port_shards(ref)
    # The wire audit, faults and checkpoint/resume are ported since: they run,
    # and refuse bad arguments as the reference does.
    assert eng.run(shards, rounds=1, wire="audit")["wire"]["uplink_err_bits"] == 0.0
    with pytest.raises(ValueError, match="expected a FaultPlan"):
        eng.run(shards, rounds=1, faults=object())
    assert eng.run(shards, rounds=1, faults=FaultPlan(seed=1))["faults"]["events"] == []
    saved = eng.run(shards, rounds=1, checkpoint_dir=str(tmp_path))
    assert eng.run(shards, rounds=1, resume_from=str(tmp_path))["meter"] == saved["meter"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no valid checkpoint"):
        eng.run(shards, rounds=1, resume_from=str(tmp_path / "empty"))
    assert eng.run(shards, rounds=1, mode="fused")["mode"] == "fused"   # ported since
    with pytest.raises(ValueError):
        eng.run(shards, rounds=1, mode="scan")
    out = eng.run(shards, rounds=1, cohort_rng="jax")      # ported since
    np.testing.assert_array_equal(out["active_schedule"], [np.arange(N_CLIENTS)])
    with pytest.raises(ValueError):
        eng.run(shards, rounds=1, cohort_rng="torch")


def test_cuda_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_make_mlp(4, (3,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_make_synthetic(prng.PRNGKey(0, device="cpu"), n_train=4, n_test=4, hw=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.PRNGKey(0)


_IMPORT_PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _IMPORT_PROBE.format(src=str(REPO / "src"), root=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
