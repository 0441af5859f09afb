"""The port's training path (``repro_torch.data``, ``optim``, ``launch.train``
and the trained tree's checkpoint) against the JAX reference on the CPU.

Inputs are made with numpy from a seed (or by the reference's own
``init_params``) and handed to both packages; the reference's step runs
under ``jax.jit``, once per case for the whole module.  Every tolerance is
stated where it is used, with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.data import batches_for as j_batches
from repro.launch import train as JTR
from repro.models import transformer as JT

import repro_torch.configs as C
from repro_torch import checkpoint, convert, optim, prng
from repro_torch.data import batches_for
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

ARCH = "qwen3-1.7b"
LR, B, S, MB, STEPS, SEED = 1e-3, 4, 16, 2, 3, 0
# Both packages compute the same f32 functions in other summation orders:
# gradients agree to ~1.5e-6 of each leaf's largest entry (measured), losses
# to ~1e-7 relative.
GRAD_TOL, LOSS_RTOL = 1e-5, 1e-5
# Parameters after Adam steps: within 1e-2 lr everywhere but at the entries
# the tests name (measured: 8.3e-3 lr at most elsewhere, f32, 3 steps).
PARAM_TOL = 1e-2 * LR
# Where the reference's gradient is at rounding level (|g| <= 1e-8 while
# the leaves' gradients reach 1e-1 and the two packages differ by ~1e-7)
# Adam's first step is lr * sign(g) in effect: such entries may differ by
# up to 2 lr a step.  Adam's |m_hat| / sqrt(v_hat) is at most 1, 1.0014 and
# 1.0037 at steps 1-3 (Cauchy-Schwarz on its weights): two runs from equal
# parameters part by at most 2 lr times their sum.
ROUNDING_G = 1e-8
ADAM_MAX = (1.0, 1.0014, 1.0037)


def _spread(s: int) -> float:
    """The most two Adam runs from equal parameters can part in steps 0..s."""
    return 2 * LR * sum(ADAM_MAX[:s + 1]) + PARAM_TOL


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# data.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge", "qwen2-vl-72b"])
def test_batches_match_reference(arch):
    want = list(j_batches(RC.get(arch).reduced(), 3, 24, seed=5, n=3))
    got = list(batches_for(C.get(arch).reduced(), 3, 24, seed=5, n=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
        t = TR.batch_tensors(g, "cpu")
        for k, v in t.items():
            assert v.dtype == (torch.float32 if g[k].dtype == np.float32 else torch.int64)
            np.testing.assert_array_equal(v.numpy(), g[k])


# ---------------------------------------------------------------------------
# optim: the four optimizers, tree-generic
# ---------------------------------------------------------------------------


def _opt_tree(rng, dtype):
    """A reference-like tree: stacked 1-D leaves (n_rep, d), a stacked matrix
    (n_rep, d, f), stacked experts (n_rep, E, d, f), a vector, a matrix, in
    dicts and a list."""
    shapes = {"ln1": (3, 8), "w": (3, 8, 5), "experts": (2, 3, 4, 6), "final_norm": (7,),
              "head": (5, 4), "prefix": [{"ln1": (6,), "w": (6, 3)}]}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(dtype), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))


def _to_torch(tree):
    return tree_map(lambda a: convert._array_tensor(a, "cpu"),
                          jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name,dtype", [("sgd", "float32"), ("momentum", "float32"),
                                        ("momentum", "bfloat16"), ("adam", "float32"),
                                        ("adam", "bfloat16"), ("adafactor", "float32"),
                                        ("adafactor", "bfloat16")])
def test_optimizers_on_stacked_trees_match_reference(name, dtype):
    rng = np.random.default_rng(11)
    make = {"sgd": "sgd", "momentum": "momentum", "adam": "adam",
            "adafactor": "adafactor_like"}[name]
    jopt, topt = getattr(joptim, make)(1e-2), getattr(optim, make)(1e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), _opt_tree(rng, np.float32))
    tp = _to_torch(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = _opt_tree(rng, np.float32)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), jp, js)
        tp, ts = topt.update(_to_torch(g), tp, ts)
    want, got = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(got) == len(want)
    for w, t in zip(want, got):
        # the dtypes the arithmetic promotes to: f32 from bf16 (momentum,
        # adam), bf16 kept (adafactor casts back)
        assert str(t.dtype).split(".")[1] == str(w.dtype), (t.dtype, w.dtype)
        # f32: a few ulp of the mean reductions; bf16: one ulp of the
        # rounded result (both round the same f32 value, up to those ulps)
        tol = 1e-6 if str(w.dtype) == "float32" else 2 ** -8
        np.testing.assert_allclose(_f32(t), _f32(w), rtol=tol, atol=tol)
    for w, t in zip(jax.tree.leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(_f32(t), _f32(w), rtol=1e-5, atol=1e-7)
    if name == "adam":
        assert ts.step == int(js.step) == 3


def test_optimizers_take_a_bare_tensor():
    """``fl/tasks.py`` calls the optimizers on one tensor: a one-leaf tree."""
    p = torch.linspace(-1, 1, 12)
    for opt in (optim.sgd(0.1), optim.momentum(0.1), optim.adam(0.1),
                optim.adafactor_like(0.1)):
        new, _ = opt.update(torch.ones(12), p, opt.init(p))
        assert isinstance(new, torch.Tensor) and new.shape == p.shape
        assert bool((new < p).all())


# ---------------------------------------------------------------------------
# The stochastic sign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((7, 33), 1e-3), ((3, 64, 48), 0.2), ((5,), 1.0)])
def test_stochastic_sign_bits_match_reference(shape, scale, monkeypatch):
    g = (np.random.default_rng(3).standard_normal(shape) * scale).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    want = np.asarray(JTR._stochastic_sign_compress(jnp.asarray(g), jkey))
    tkey = convert.key(np.asarray(jkey), "cpu")
    # draw in many ranges, as a full-width leaf is drawn
    monkeypatch.setattr(TR, "SIGN_DRAW_RANGE", 37)
    got = TR._stochastic_sign_compress(torch.from_numpy(g), tkey).numpy()
    flips = int((np.sign(got) != np.sign(want)).sum())
    k_want, k_got = np.abs(want).max(), np.abs(got).max()
    assert flips == 0, (f"{flips} of {g.size} signs differ; K {k_got!r} vs the "
                        f"reference's {k_want!r}")
    # K = mean |g|: two summation orders of f32 terms
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-6)
    p = torch.sigmoid(torch.from_numpy(g) / torch.from_numpy(np.abs(g)).mean())
    assert torch.equal(TR._bernoulli(tkey, p), prng.bernoulli(tkey, p))


# ---------------------------------------------------------------------------
# Whole train steps on the reduced qwen3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_init():
    """The reference trainer's initial parameters (``init_params`` on
    ``PRNGKey(0)``) as numpy, and the batches."""
    cfg = RC.get(ARCH).reduced()
    params, _ = JT.init_params(JT.build(cfg), jax.random.PRNGKey(SEED))
    return _np(params), list(j_batches(cfg, B, S, n=STEPS))


_RUNS, _JGRAD = {}, {}


def _ref_run(ref_init, comp, dtype):
    """The reference's jitted ``make_train_step`` under the ``Trainer``'s key
    schedule: per step the parameters before it, its loss, the dtypes of
    the parameters and Adam's moments after it; cached per case."""
    if (comp, dtype) in _RUNS:
        return _RUNS[comp, dtype]
    params0, batches = ref_init
    cfg = dataclasses.replace(RC.get(ARCH).reduced(), dtype=dtype)
    model = JT.build(cfg)
    # init_params draws in f32 and casts: casting the f32 draw is its bf16 init
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params0)
    opt = joptim.adam(LR)
    state = opt.init(params)
    step = jax.jit(JTR.make_train_step(model, opt, microbatches=MB, kv_chunk=S,
                                       grad_compression=comp))
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 1)
    out = []
    for b in batches:
        key, k = jax.random.split(key)
        before = _np(params)
        loss, params, state = step(params, state, {n: jnp.asarray(v) for n, v in b.items()}, k)
        out.append(dict(before=before, loss=float(loss), key=np.asarray(k),
                        dtypes=[str(a.dtype) for a in jax.tree.leaves(params)],
                        mu=[str(a.dtype) for a in jax.tree.leaves(state.mu)]))
    out.append(dict(before=_np(params)))
    _RUNS[comp, dtype] = out
    return out


def _port_run(ref_init, comp, dtype):
    params0, _ = ref_init
    cfg = dataclasses.replace(C.get(ARCH).reduced(), dtype=dtype)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), params0)
    tr = TR.Trainer(cfg, lr=LR, microbatches=MB, kv_chunk=S, grad_compression=comp,
                    seed=SEED, params=convert.stacked_params(tree, "cpu"), device="cpu")
    out = []
    for b in batches_for(cfg, B, S, n=STEPS):
        loss = tr.step(b)
        out.append(dict(loss=loss, params=[_f32(t) for t in tree_leaves(tr.params)],
                        dtypes=[str(t.dtype).split(".")[1]
                                for t in tree_leaves(tr.params)],
                        mu=[str(t.dtype).split(".")[1]
                            for t in tree_leaves(tr.opt_state.mu)]))
    return out


def _mean_grads(params, batch, *, port):
    """The microbatch-mean gradient at ``params`` (a numpy reference tree),
    as the step accumulates it, from the reference (jax) or the port."""
    halves = [{k: v[i * (B // MB):(i + 1) * (B // MB)] for k, v in batch.items()}
              for i in range(MB)]
    if port:
        model = T.build(C.get(ARCH).reduced())
        loss_fn = TR.make_loss_fn(model, kv_chunk=S)
        tree = tree_map(lambda t: t.requires_grad_(), convert.stacked_params(params, "cpu"))
        acc = None
        for h in halves:
            gs = torch.autograd.grad(loss_fn(tree, TR.batch_tensors(h, "cpu")),
                                     tree_leaves(tree))
            acc = [g.clone() for g in gs] if acc is None else [a + g for a, g in zip(acc, gs)]
        return [a.numpy() / MB for a in acc]
    model = JT.build(RC.get(ARCH).reduced())
    vg = _JGRAD.setdefault("fn", jax.jit(jax.grad(JTR.make_loss_fn(model, kv_chunk=S))))
    gs = [jax.tree.leaves(vg(jax.tree.map(jnp.asarray, params),
                             {k: jnp.asarray(v) for k, v in h.items()})) for h in halves]
    return [(np.asarray(a) + np.asarray(b)) / MB for a, b in zip(*gs)]



@pytest.mark.parametrize("comp", [None, "stochastic_sign"])
def test_train_steps_match_reference(ref_init, comp):
    """Three steps, microbatches 2: the losses, each step's gradients at the
    reference's parameters, and the parameters after each step, leaf by
    leaf in the reference's layout."""
    ref = _ref_run(ref_init, comp, "float32")
    got = _port_run(ref_init, comp, "float32")
    _, batches = ref_init
    g_min = None
    for s in range(STEPS):
        assert got[s]["loss"] == pytest.approx(ref[s]["loss"], rel=LOSS_RTOL)
        gj = _mean_grads(ref[s]["before"], batches[s], port=False)
        gt = _mean_grads(ref[s]["before"], batches[s], port=True)
        for a, b in zip(gj, gt):
            np.testing.assert_allclose(b, a, atol=GRAD_TOL * np.abs(a).max(), rtol=0)
        g_abs = [np.abs(a) for a in gj]
        g_min = g_abs if g_min is None else [np.minimum(m, a) for m, a in zip(g_min, g_abs)]
        if s == 0:
            flips = _predicted_flips(ref[0]["key"], gj, gt) if comp else None
        want = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref[s + 1]["before"])]
        outliers, n = 0, 0
        for i, (w, t) in enumerate(zip(want, got[s]["params"])):
            far = np.abs(t - w) > PARAM_TOL
            n += w.size
            outliers += int(far.sum())
            assert np.all(np.abs(t - w) <= _spread(s))
            if comp is None:
                # only where the reference's gradient is at rounding level
                assert np.all(g_min[i][far] <= ROUNDING_G), (i, np.abs(t - w)[far])
            elif s == 0:
                # only where the reference's and the port's gradients give a
                # sign probability on either side of the uniform drawn
                assert np.all(flips[i][far]), (i, np.argwhere(far & ~flips[i]))
        if comp:
            # flips spread: each flipped sign moves every later gradient
            assert outliers <= 1e-4 * n, outliers
        print(f"step {s}: {outliers} of {n} entries beyond {PARAM_TOL:.0e}"
              + (f"; predicted sign flips at step 0: {sum(int(f.sum()) for f in flips)}"
                 if comp else ""))


def _predicted_flips(key, gj, gt, slack=1e-6):
    """Per leaf, where the sign drawn from the reference's gradient may
    differ from the one drawn from the port's: the uniform lies between the
    two sign probabilities (within ``slack``, the f32 rounding of sigmoid
    and of the reference's fused in-step arithmetic)."""
    keys = prng.split(convert.key(key, "cpu"), len(gj))
    out = []
    for i, (a, b) in enumerate(zip(gj, gt)):
        qa, qb = (torch.sigmoid(torch.from_numpy(g) / (np.abs(g).mean() + 1e-12))
                  for g in (a, b))
        u = prng.uniform(keys[i], a.shape)
        lo, hi = torch.minimum(qa, qb) - slack, torch.maximum(qa, qb) + slack
        out.append(((u >= lo) & (u < hi)).numpy())
    return out


def test_bf16_promotion_matches_reference(ref_init):
    """A bf16 config under Adam: the f32 gradient accumulators promote the
    parameters and both moments to f32 after the first step, in both
    packages; later steps run the model in f32."""
    ref = _ref_run(ref_init, None, "bfloat16")
    got = _port_run(ref_init, None, "bfloat16")
    for s in range(STEPS):
        assert got[s]["dtypes"] == ref[s]["dtypes"] == ["float32"] * len(got[s]["dtypes"])
        assert got[s]["mu"] == ref[s]["mu"]
        # bf16 forward at step 0 (one bf16 ulp, 2^-8, of the logits' scale);
        # then f32 from parameters that part at bf16-rounding-level grads
        assert got[s]["loss"] == pytest.approx(ref[s]["loss"], rel=2 ** -8)
        want = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref[s + 1]["before"])]
        far = sum(int((np.abs(t - w) > PARAM_TOL).sum())
                  for w, t in zip(want, got[s]["params"]))
        for w, t in zip(want, got[s]["params"]):
            assert np.all(np.abs(t - w) <= _spread(s))
        print(f"step {s}: {far} entries beyond {PARAM_TOL:.0e} (bf16 gradients)")


# ---------------------------------------------------------------------------
# The CLI and its checkpoint
# ---------------------------------------------------------------------------


def test_cli_checkpoint_is_the_reference_tree(tmp_path):
    """``--ckpt`` writes the reference's stacked tree through the port's
    ``checkpoint.save``; ``repro.checkpoint.load`` reads it back into equal
    arrays, in the reference's ``init_params`` structure."""
    path = str(tmp_path / "run.ckpt")
    rc = TR.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--microbatches", "2", "--bicompfl",
                  "--ckpt", path])
    assert rc in (0, 1)
    tree, step = jckpt.load(path)
    assert step == 2
    cfg = RC.get(ARCH).reduced()
    want = jax.eval_shape(lambda k: JT.init_params(JT.build(cfg), k)[0],
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == np.float32
    # a trainer's parameters, saved and loaded by the reference
    tr = TR.Trainer(C.get(ARCH).reduced(), device="cpu")
    tr.step(next(batches_for(tr.cfg, 2, 16, n=1)))
    checkpoint.save(path, tr.params, step=1)
    tree, step = jckpt.load(path)
    assert step == 1
    for a, t in zip(jax.tree.leaves(tree), tree_leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


@pytest.mark.parametrize("arch,n_layers", [("kimi-k2-1t-a32b", 3),
                                            ("llama4-maverick-400b-a17b", 4)])
def test_stacked_layout_round_trip(arch, n_layers):
    """``stack_model_params`` inverts ``model_params``; ``layer_views`` are
    views of the stacked leaves.  Kimi K2 at 3 layers: a dense prefix layer
    and one MoE pattern position repeated twice; Llama 4 at 4: a pattern of
    two positions (dense, MoE) repeated twice."""
    cfg = dataclasses.replace(RC.get(arch).reduced(), n_layers=n_layers)
    ref, _ = JT.init_params(JT.build(cfg), jax.random.PRNGKey(1))
    ref = _np(ref)
    model = T.build(dataclasses.replace(C.get(arch).reduced(), n_layers=n_layers))
    assert model.n_rep == 2
    stacked = convert.stack_model_params(
        model, convert.model_params(model.cfg, ref, device="cpu"))
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), stacked))
    for a, t in zip(jax.tree.leaves(ref), tree_leaves(stacked)):
        np.testing.assert_array_equal(_f32(t), _f32(a))
    direct = convert.stacked_params(ref, "cpu")
    views = convert.layer_views(model, direct)
    assert len(views) == cfg.n_layers
    for view, layer in zip(views, convert.model_params(model.cfg, ref, device="cpu")["layers"]):
        for a, b in zip(tree_leaves(view), tree_leaves(layer)):
            assert torch.equal(a, b)
            assert any(a.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
                       for s in tree_leaves(direct))
