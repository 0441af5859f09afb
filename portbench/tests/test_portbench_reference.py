"""The plain references agree with the port on the CPU at tiny sizes, and the
controls (the references one precision lower) do not."""
import pytest
import torch
from conftest import rehearse, tiny_lm

from portbench.drivers import fl_jobs, train_steps
from portbench.harness import correct
from portbench.reference import fl_mask, qwen3_train
from portbench.yardstick import fl_data, lm_params
from portbench.yardstick import threefry as tf
from portbench.yardstick.lm_stream import TokenStream


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_mrc_indices_and_samples_are_the_ports(seed):
    """One round's uplink encode: indices and samples equal to the port's
    fixed-block encoder over the round's common candidates."""
    from repro_torch.core import mrc
    from repro_torch.fl.channels import TAG_UL_SELECT
    n, d, block, n_is = 4, 1000, 128, 64
    g = torch.Generator().manual_seed(seed % 1000)
    q = torch.rand(n, d, generator=g)
    p = (q + 0.1 * torch.randn(n, d, generator=g)).clamp(0, 1)
    kt = tf.fold_in(tf.key(seed, "cpu"), 5)
    ids = torch.arange(n)
    idx, sample = fl_mask.mrc_encode(kt, q, p, ids, block=block, n_is=n_is)
    nb = -(-d // block)
    pad = torch.full((n, nb * block - d), 0.5)
    qb, pb = (torch.cat([fl_mask.clip01(v), pad], -1).reshape(n, nb, block) for v in (q, p))
    sels = tf.fold_in(tf.fold_in(kt, TAG_UL_SELECT), ids)
    pidx, psample = mrc.transmit_fixed(kt, sels, qb, pb, n_is=n_is)
    assert torch.equal(idx, pidx[:, 0])
    assert torch.equal(sample, psample.reshape(n, -1)[:, :d])


def test_a_gr_fixed_job_is_the_ports_bit_for_bit(tiny_fl):
    cfg, traffic = tiny_fl
    res = rehearse(fl_jobs, cfg, traffic)
    assert res.attempted >= 2 and correct(res), res.checks
    assert all(v == 0 for _, v, _ in res.checks)


def test_one_gr_fixed_round_books_the_ports_bits(tiny_fl):
    cfg, traffic = tiny_fl
    traffic = dict(traffic, rounds=1, eval_every=1)
    engine, shards, inputs = fl_jobs.build(cfg, traffic, 11, "cpu")
    out = engine.run(shards, rounds=1, seed=12, eval_every=1)
    ref = fl_mask.run_job(inputs, 12, cfg, traffic)
    assert torch.equal(out["theta"], ref["theta"])
    assert out["meter"]["total_bits"] == ref["total_bits"]


@pytest.mark.parametrize("traffic_name", ["train", "train-sign"])
def test_the_first_steps_are_the_ports(traffic_name):
    cfg, traffic = tiny_lm(traffic_name)
    res = rehearse(train_steps, cfg, traffic)
    gaps = {n: v for n, v, _ in res.checks}
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert correct(res)


@pytest.mark.parametrize("traffic_name", ["train", "train-sign"])
def test_the_training_control_is_not_correct(traffic_name):
    """The reference with fp8 products in its bf16 first step, in the
    program's place, fails one of the numbers under the cell's limits."""
    cfg, traffic = tiny_lm(traffic_name)
    seed = 2 ** 31 + 5
    stream = TokenStream(cfg["vocab_size"], seed).stream(traffic["batch"], traffic["seq"])
    batches = [next(stream) for _ in range(train_steps.CHECKED_STEPS)]

    def steps(**kw):
        return qwen3_train.run_steps(cfg, lm_params.draw(cfg, seed, "cpu"), batches, traffic,
                                     seed, **kw)

    gaps = qwen3_train.compare(steps(low=True), steps())
    assert any(gaps[n] > lim for n, lim in traffic["limits"].items()), gaps


@pytest.mark.cuda
def test_the_fl_control_is_not_correct(card):
    """At the cell's size on the card: local training's products in TF32
    move the final model."""
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    cfg = json.loads((root / "portbench/configs/fl-mlp-mnist.json").read_text())
    traffic = json.loads((root / "portbench/traffic/gr-fixed.json").read_text())
    inputs = fl_data.make_inputs(2 ** 31 + 3, cfg, "cuda")
    ref = fl_mask.run_job(inputs, 41, cfg, traffic)
    gaps = fl_mask.compare(fl_mask.run_job(inputs, 41, cfg, traffic, tf32=True), ref)
    assert any(gaps[n] > lim for n, lim in traffic["limits"].items()), gaps
