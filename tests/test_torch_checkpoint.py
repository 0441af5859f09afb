"""The port's checkpoint format (``repro_torch.checkpoint``) and crash-safe
resume (``FLEngine.run(checkpoint_dir=, resume_from=)``), on the CPU.

* **format** -- ``tests/test_checkpoint.py``'s contract on the port's
  module: atomic writes, the self-describing load, corrupt-file skipping,
  the per-step directory; the header's ``treedef`` is jax's string and a
  file the port writes is the reference's byte for byte;
* **files cross** -- the port's ``load`` reads the reference's files and the
  reference's ``load`` reads the port's; an engine checkpoint of either
  package has the other's tree layout and values;
* **resume** -- a port run killed after round 2 (later checkpoints deleted)
  and resumed is bit-identical to the uninterrupted one, host and fused,
  clean and faulted, on a mask and an error-feedback family; the port
  resumes the reference's round-2 checkpoint and ends at the reference's
  uninterrupted theta, meter and history, and the reference resumes the
  port's; a mismatched configuration is refused.
"""
import glob
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.fl import faults as jfaults
from repro.fl import registry as jreg
from repro.fl.data import make_synthetic, partition_iid
from repro.fl.engine import FLEngine as JEngine
from repro.fl.nets import make_mlp
from repro.fl.tasks import make_cfl_task, make_mask_task
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.fl import registry as treg
from repro_torch.fl.engine import FLEngine
from repro_torch.fl.faults import FaultPlan

N, D = 4, 208
T_MATRIX = {s[0]: s for s in treg.fault_matrix(n=N, d=D, n_is=16, block=16, reset_period=2)}
J_MATRIX = {s[0]: s for s in jreg.fault_matrix(n=N, d=D, n_is=16, block=16, reset_period=2)}
RATES = dict(drop_rate=0.3, straggler_rate=0.1, corrupt_rate=0.2, seed=5)
PLAN = FaultPlan(**RATES)


def _tree():
    return {
        "theta": np.arange(6, dtype=np.float32).reshape(2, 3),
        "nested": {"b": np.float64(2.5), "a": np.int32(7)},
        "seq": [np.ones(2, np.float32), (np.zeros((), np.int64), None)],
        "empty": (),
        "one": (np.uint8(3),),
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The format.
# ---------------------------------------------------------------------------


class TestFormat:

    def test_roundtrip_without_reference_tree(self, tmp_path):
        path = str(tmp_path / "c.repro")
        ckpt.save(path, _tree(), step=3)
        tree, step = ckpt.load(path)
        assert step == 3
        _assert_tree_equal(tree, _tree())

    def test_bytes_and_treedef_are_the_references(self, tmp_path):
        ours, theirs = str(tmp_path / "p.repro"), str(tmp_path / "j.repro")
        ckpt.save(ours, _tree(), step=9)
        jckpt.save(theirs, _tree(), step=9)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        assert ckpt._treedef(_tree()) == str(jax.tree.structure(_tree()))

    def test_non_alphabetical_dict_keys_rebuild_unscrambled(self, tmp_path):
        path = str(tmp_path / "c.repro")
        src = {"z": np.full(3, 1.0, np.float32), "a": np.full(3, 2.0, np.float32)}
        ckpt.save(path, src)
        _assert_tree_equal(ckpt.load(path)[0], src)

    def test_scalars_and_tensors(self, tmp_path):
        path = str(tmp_path / "c.repro")
        w = torch.linspace(0, 1, 7)
        ckpt.save(path, {"x": 0.1, "n": 123456789, "w": w})
        tree, _ = ckpt.load(path)
        assert float(tree["x"]) == 0.1 and int(tree["n"]) == 123456789
        np.testing.assert_array_equal(tree["w"], w.numpy())
        back = ckpt.restore(path, {"x": 0.0, "n": 0, "w": torch.zeros(7)})
        assert torch.equal(back["w"], w)
        with pytest.raises(ValueError, match="mesh"):
            ckpt.restore(path, {"x": 0.0, "n": 0, "w": torch.zeros(7)}, mesh=object())
        with pytest.raises(ckpt.CheckpointError, match="leaves"):
            ckpt.restore(path, {"w": torch.zeros(7)})

    def test_atomic_save_leaves_no_temp_and_replaces(self, tmp_path):
        path = str(tmp_path / "c.repro")
        ckpt.save(path, {"a": np.zeros(1000, np.float64)})
        big = os.path.getsize(path)
        ckpt.save(path, {"a": np.zeros(1, np.float64)})
        assert os.listdir(tmp_path) == ["c.repro"]
        assert os.path.getsize(path) < big
        deep = str(tmp_path / "deep" / "er" / "c.repro")
        ckpt.save(deep, _tree())
        assert ckpt.validate(deep)[0]

    @pytest.mark.parametrize("damage", ["magic", "truncated", "header"])
    def test_corruption_is_detected(self, tmp_path, damage):
        path = str(tmp_path / "c.repro")
        ckpt.save(path, _tree(), step=5)
        assert ckpt.validate(path) == (True, 5, "")
        data = bytearray(open(path, "rb").read())
        if damage == "magic":
            data[:10] = b"NOTACKPT??"
        elif damage == "truncated":
            data = data[:-4]
        else:
            data[len(ckpt.MAGIC) + 8] ^= 0xFF
        open(path, "wb").write(bytes(data))
        ok, _, reason = ckpt.validate(path)
        assert not ok
        if damage != "header":
            assert ("magic" if damage == "magic" else "truncated") in reason
            with pytest.raises(ckpt.CheckpointError):
                ckpt.load(path)
        with pytest.warns(RuntimeWarning, match="corrupt"):
            assert ckpt.latest_step(path) is None
        assert ckpt.latest_step(str(tmp_path / "absent.repro")) is None

    def test_step_directory_picks_the_newest_valid(self, tmp_path):
        d = str(tmp_path)
        assert ckpt.latest(d) == (None, None)
        assert ckpt.latest(str(tmp_path / "nope")) == (None, None)
        for s in (2, 4, 6):
            ckpt.save_step(d, {"s": np.zeros(64, np.float64) + s}, s)
        open(os.path.join(d, "notes.txt"), "w").write("hi")
        assert ckpt.latest(d) == (ckpt.step_path(d, 6), 6)
        p6 = ckpt.step_path(d, 6)
        data = open(p6, "rb").read()
        open(p6, "wb").write(data[: len(data) // 2])
        with pytest.warns(RuntimeWarning, match="corrupt"):
            path, step = ckpt.latest(d)
        assert step == 4 and ckpt.load(path)[0]["s"][0] == 4.0
        assert os.path.basename(path) == jckpt.step_path(".", 4)[2:]


def test_files_cross_both_ways(tmp_path):
    src = dict(_tree(), w=np.linspace(0, 1, 5, dtype=np.float32))
    jpath, tpath = str(tmp_path / "j.repro"), str(tmp_path / "t.repro")
    jckpt.save(jpath, dict(src, w=jnp.asarray(src["w"])), step=2)
    ckpt.save(tpath, dict(src, w=torch.from_numpy(src["w"])), step=2)
    for path in (jpath, tpath):
        for load in (ckpt.load, jckpt.load):
            tree, step = load(path)
            assert step == 2
            _assert_tree_equal(tree, src)
    hdr = lambda p: open(p, "rb").read()[len(ckpt.MAGIC) + 8:]  # noqa: E731
    assert struct.unpack("<Q", open(tpath, "rb").read()[10:18]) == \
        struct.unpack("<Q", open(jpath, "rb").read()[10:18])
    assert hdr(tpath) == hdr(jpath)


# ---------------------------------------------------------------------------
# Resume.
# ---------------------------------------------------------------------------


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
    cfl, theta0 = make_cfl_task(make_mlp(in_dim=16, widths=(8,)), jax.random.fold_in(k, 4),
                                test.x, test.y, local_epochs=2, batch_size=10,
                                local_lr=3e-3)
    tcfl, ttheta0 = convert.cfl_task(theta0, cfl.x_test, cfl.y_test, dims=(16, 8, 10),
                                     device="cpu", local_epochs=2, batch_size=10,
                                     local_lr=3e-3)
    return {"mask": ((mask, None), (tmask, None)), "delta": ((cfl, theta0), (tcfl, ttheta0)),
            "shards": shards, "tshards": convert.dataset(shards.x, shards.y, "cpu")}


def _kill_after(ckdir, step):
    """Drop every checkpoint but round ``step``'s: the run "crashed" there."""
    keep = os.path.basename(ckpt.step_path(ckdir, step))
    for p in glob.glob(os.path.join(ckdir, "ckpt_*.repro")):
        if os.path.basename(p) != keep:
            os.remove(p)


def _assert_identical(a, b):
    assert a["history"] == b["history"]
    assert a["meter"] == b["meter"]
    np.testing.assert_array_equal(np.asarray(a["theta"]), np.asarray(b["theta"]))
    np.testing.assert_array_equal(np.asarray(a["theta_hat"]), np.asarray(b["theta_hat"]))


@pytest.mark.parametrize("faults", [None, PLAN], ids=["clean", "faulted"])
@pytest.mark.parametrize("mode", ["host", "fused"])
@pytest.mark.parametrize("name", ["bicompfl-pr", "doublesqueeze"])
def test_resume_matches_uninterrupted(setups, tmp_path, name, mode, faults):
    _, kind, factory = T_MATRIX[name]
    task, theta0 = setups[kind][1]
    shards = setups["tshards"]
    kw = dict(rounds=4, seed=7, mode=mode, faults=faults)
    full = FLEngine(task, factory()).run(shards, theta0, **kw)
    ckdir = str(tmp_path / "ck")
    saved = FLEngine(task, factory()).run(shards, theta0, checkpoint_dir=ckdir,
                                          checkpoint_every=2, **kw)
    _assert_identical(full, saved)
    assert sorted(os.listdir(ckdir)) == ["ckpt_00000002.repro", "ckpt_00000004.repro"]
    _kill_after(ckdir, 2)
    resumed = FLEngine(task, factory()).run(shards, theta0, resume_from=ckdir, **kw)
    _assert_identical(full, resumed)
    if faults is not None:
        assert resumed["faults"] == full["faults"]
        assert full["faults"]["summary"]["faulty_rounds"] > 0


def test_fused_resume_replays_the_captured_program(setups, tmp_path):
    """One engine: the resumed run reuses the program the checkpointed run
    captured, starting its round counter at the saved round."""
    _, kind, factory = T_MATRIX["bicompfl-pr"]
    task = setups[kind][1][0]
    eng = FLEngine(task, factory())
    ckdir = str(tmp_path / "ck")
    full = eng.run(setups["tshards"], rounds=4, seed=7, mode="fused", faults=PLAN,
                   checkpoint_dir=ckdir, checkpoint_every=2)
    captures, replays = eng.fused_capture_count, eng.fused_replay_count
    _kill_after(ckdir, 2)
    resumed = eng.run(setups["tshards"], rounds=4, seed=7, mode="fused", faults=PLAN,
                      resume_from=ckdir)
    assert eng.fused_capture_count == captures
    assert eng.fused_replay_count == replays + 3 * 2          # train + codec + eval, 2 rounds
    _assert_identical(full, resumed)


@pytest.mark.parametrize("faults", [None, "plan"], ids=["clean", "faulted"])
def test_checkpoints_cross_between_the_engines(setups, tmp_path, faults):
    """PR on the host loop: the port resumes the reference's round-2
    checkpoint and ends at the reference's uninterrupted run; the reference
    resumes the port's and ends there too; the round-2 files hold the same
    tree, bit for bit."""
    (jtask, _), (ttask, _) = setups["mask"]
    jplan = jfaults.FaultPlan(**RATES) if faults else None
    tplan = PLAN if faults else None
    kw = dict(rounds=4, seed=7, mode="host")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    want = JEngine(jtask, J_MATRIX["bicompfl-pr"][2]()).run(
        setups["shards"], checkpoint_dir=jdir, checkpoint_every=2, faults=jplan, **kw)
    FLEngine(ttask, T_MATRIX["bicompfl-pr"][2]()).run(
        setups["tshards"], checkpoint_dir=tdir, checkpoint_every=2, faults=tplan, **kw)
    _assert_tree_equal(ckpt.load(ckpt.step_path(tdir, 2))[0],
                       jckpt.load(jckpt.step_path(jdir, 2))[0])
    _kill_after(jdir, 2)
    _kill_after(tdir, 2)
    got = FLEngine(ttask, T_MATRIX["bicompfl-pr"][2]()).run(
        setups["tshards"], resume_from=jdir, faults=tplan, **kw)
    _assert_identical(want, got)
    back = JEngine(jtask, J_MATRIX["bicompfl-pr"][2]()).run(
        setups["shards"], resume_from=tdir, faults=jplan, **kw)
    _assert_identical(want, back)


def test_resume_refuses_a_mismatched_config(setups, tmp_path):
    _, kind, factory = T_MATRIX["bicompfl-pr"]
    task = setups[kind][1][0]
    ckdir = str(tmp_path / "ck")
    FLEngine(task, factory()).run(setups["tshards"], rounds=2, seed=7, mode="host",
                                  checkpoint_dir=ckdir, checkpoint_every=1)
    with pytest.raises(ValueError, match="config"):
        FLEngine(task, factory()).run(setups["tshards"], rounds=2, seed=8, mode="host",
                                      resume_from=ckdir)
    with pytest.raises(ValueError, match="config"):
        FLEngine(task, factory()).run(setups["tshards"], rounds=2, seed=7, mode="host",
                                      resume_from=ckdir, faults=PLAN)
    with pytest.raises(ValueError, match="no valid checkpoint"):
        FLEngine(task, factory()).run(setups["tshards"], rounds=2, seed=7, mode="host",
                                      resume_from=str(tmp_path))
