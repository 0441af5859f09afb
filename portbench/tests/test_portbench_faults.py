"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the port, driven through the rest of a
run on the CPU."""
import pytest
import torch
from conftest import rehearse, tiny_lm

from portbench.drivers import fl_jobs, train_steps
from portbench.harness import correct


def _fl_state_unchanged(mp):
    from repro_torch.fl import engine
    mp.setattr(engine._FusedProgram, "_store", lambda self, *carry: None)


def _fl_half_the_clients(mp):
    from repro_torch.fl import engine
    real = engine._cohort_mean
    mp.setattr(engine, "_cohort_mean", lambda ctx, x: real(ctx, x[: x.shape[0] // 2]))


def _fl_answer_altered(mp):
    from repro_torch.core import mrc
    real = mrc.encode_fixed

    def altered(*args, **kw):
        res = real(*args, **kw)
        sample = res.sample.clone()
        sample[..., 0, 0, 0] = 1.0 - sample[..., 0, 0, 0]
        return mrc.MRCResult(indices=res.indices, sample=sample)

    mp.setattr(mrc, "encode_fixed", altered)


def _fl_bits_miscounted(mp):
    from repro_torch.fl.channels import IndexRelayDownlink
    real = IndexRelayDownlink.step_down

    def step_down(self, ctx, state, update, theta, theta_hat):
        res, state = real(self, ctx, state, update, theta, theta_hat)
        return res._replace(bits=res.bits + 1.0), state

    mp.setattr(IndexRelayDownlink, "step_down", step_down)


def _fl_accuracy_altered(mp):
    from repro_torch.fl.tasks import MaskTask
    real = MaskTask.accuracy
    mp.setattr(MaskTask, "accuracy", lambda self, theta: real(self, theta) * 0.5)


@pytest.mark.parametrize("fault", [_fl_state_unchanged, _fl_half_the_clients,
                                   _fl_answer_altered, _fl_bits_miscounted,
                                   _fl_accuracy_altered], ids=lambda f: f.__name__[4:])
def test_a_broken_fl_round_is_not_correct(fault, tiny_fl, monkeypatch):
    fault(monkeypatch)
    cfg, traffic = tiny_fl
    res = rehearse(fl_jobs, cfg, traffic)
    assert not correct(res), res.checks


def _train_state_unchanged(mp):
    from repro_torch.launch import train
    real = train.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def unchanged(params, opt_state, batch, key=None):
            loss, _, _ = step(params, opt_state, batch, key)
            return loss, params, opt_state

        return unchanged

    mp.setattr(train, "make_train_step", make)


def _train_half_the_batch(mp):
    from repro_torch.launch import train
    real = train.batch_tensors
    mp.setattr(train, "batch_tensors",
               lambda batch, device: {k: v[: v.shape[0] // 2] for k, v in
                                      real(batch, device).items()})


@pytest.mark.parametrize("traffic_name", ["train", "train-sign"])
@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_the_batch],
                         ids=lambda f: f.__name__[7:])
def test_a_broken_train_step_is_not_correct(fault, traffic_name, monkeypatch):
    fault(monkeypatch)
    cfg, traffic = tiny_lm(traffic_name)
    res = rehearse(train_steps, cfg, traffic)
    assert not correct(res), res.checks


def test_an_unbroken_run_is_correct(tiny_fl):
    cfg, traffic = tiny_fl
    assert correct(rehearse(fl_jobs, cfg, traffic))
    assert torch.get_num_threads() == 2
