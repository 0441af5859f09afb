"""The port's op cost model, roofline and dry run against the JAX reference
on the CPU.

The reference's dry run cannot lower on a production mesh under jax 0.9
(ROADMAP "Reference caveats"), so the port is held to what still runs
there: ``hlo_cost.analyze_text`` of single-device compiles (prefill and the
train step at the reduced size), ``model_flops`` and
``default_microbatches``, and its roofline arithmetic.  Every tolerance is
stated where it is used.  ~30 s on one worker, most of it the reference's
compiles.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pt_leaves

import repro.configs as RC
from repro.launch import hlo_cost
from repro.launch import train as JTR
from repro.models import sharding as JS, transformer as JT

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attn import flash_attention_ref
from repro_torch.launch import dryrun, op_cost, roofline as RL
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, Mesh, \
    make_host_mesh
from repro_torch.models import rwkv6, sharding as S, transformer as T
from repro_torch.tree import tree_leaves

B, SEQ = 2, 64
# The issue's measured counts (both packages), reduced configs at (2, 64),
# kv_chunk = S.
PREFILL_FLOPS = {"qwen3-1.7b": 84_148_224, "kimi-k2-1t-a32b": 156_106_752,
                 "jamba-v0.1-52b": 661_389_312}


def _ref_dryrun():
    """The reference's dry-run module, imported with ``XLA_FLAGS`` restored
    (it appends a host device count at import)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _ref_batch(cfg, b, s, train=False):
    f = jax.ShapeDtypeStruct
    out = {"tokens": f((b, s), jnp.int32)} if cfg.embed_inputs \
        else {"inputs": f((b, s, cfg.d_model), jnp.float32)}
    if train:
        out["labels"] = f((b, s), jnp.int32)
    return out


def _meta_batch(ref_batch):
    dt = {jnp.int32: torch.int32, jnp.float32: torch.float32}
    return {k: torch.empty(v.shape, dtype=dt[v.dtype.type], device="meta")
            for k, v in ref_batch.items()}


def _ref_prefill_flops(cfg):
    JS.set_mesh(None)
    model = JT.build(cfg)
    sds, _ = JT.abstract_init(model)
    fn = jax.jit(lambda p, b: JT.prefill_step(model, p, b, kv_chunk=SEQ))
    return hlo_cost.analyze_text(fn.lower(sds, _ref_batch(cfg, B, SEQ)).compile().as_text()).flops


def _port_prefill(cfg, b=B, s=SEQ, device="meta"):
    model = T.build(cfg)
    if device == "meta":
        params = convert.params_view(model, T.abstract_init(model)[0])
        batch = _meta_batch(_ref_batch(cfg, b, s))
    else:
        params = T.init_params(model, 0, device)
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device)}
    return op_cost.analyze(T.prefill_step, model, params, batch, kv_chunk=s)


@pytest.mark.parametrize("arch", list(PREFILL_FLOPS))
def test_prefill_flops_equal_reference(arch):
    """Every matrix product the reference's compiled prefill counts, the
    port's trace counts: equal exactly."""
    want = _ref_prefill_flops(RC.get(arch).reduced())
    got = _port_prefill(C.get(arch).reduced())
    assert want == PREFILL_FLOPS[arch]
    assert got.flops == want


def test_prefill_flops_rwkv_chunked():
    """``rwkv6-1.6b`` has ``scan_chunk=0``: the reference's prefill runs the
    per-token scan (121,896,960 flop here), the port the chunked form.  The
    port's count is held to the chunked form: its ``rwkv_time_mix`` region
    is the form's own products (per chunk of C: r.S, the intra-chunk scores
    and their values, the bonus, the state), and the whole prefill equals
    the reference's run with ``scan_chunk=64`` plus the last chunk's state
    product, which the prefill discards: XLA drops it as dead code, eager
    torch computes it."""
    cfg = C.get("rwkv6-1.6b").reduced()
    rcfg = RC.get("rwkv6-1.6b").reduced()
    got = _port_prefill(cfg)
    h, dh = rwkv6.head_layout(cfg)
    c, layers = 64, cfg.n_layers
    per_chunk = 2 * B * c * h * dh * dh + 2 * (2 * B * c * c * h * dh) + 2 * B * c * h * dh \
        + 2 * B * c * h * dh * dh
    assert got.flops_by_region["rwkv_time_mix"] == per_chunk * layers * (SEQ // c)
    chunked = _ref_prefill_flops(dataclasses.replace(rcfg, scan_chunk=c))
    assert got.flops == chunked + layers * 2 * B * c * h * dh * dh
    assert _ref_prefill_flops(rcfg) == 121_896_960


def test_train_flops_against_reference():
    """The reduced qwen3's train step (batch 4 x 64, 2 microbatches, Adam):
    the port counts the reference's products plus one attention forward per
    layer and microbatch, exactly: its attention backward recomputes the
    plain scan's forward before differentiating it (``ops._plain_grads``),
    where the reference differentiates the scan it ran."""
    JS.set_mesh(None)
    rcfg, cfg = RC.get("qwen3-1.7b").reduced(), C.get("qwen3-1.7b").reduced()
    bsz, mb = 4, 2
    setup = JTR.build_setup(rcfg, microbatches=mb, kv_chunk=SEQ)
    rb = _ref_batch(rcfg, bsz, SEQ, train=True)
    text = jax.jit(setup.step_fn).lower(setup.params_sds, setup.opt_sds, rb,
                                        jax.ShapeDtypeStruct((2,), jnp.uint32)).compile().as_text()
    want = hlo_cost.analyze_text(text).flops
    ts = TR.build_setup(cfg, microbatches=mb, kv_chunk=SEQ)
    got = op_cost.analyze(ts.step_fn, ts.params_sds, ts.opt_sds, _meta_batch(rb),
                          torch.empty(2, dtype=torch.int64, device="meta"))
    q = torch.empty((bsz // mb, SEQ, cfg.n_heads, cfg.head_dim), device="meta")
    kv = torch.empty((bsz // mb, SEQ, cfg.n_kv_heads, cfg.head_dim), device="meta")
    attn = op_cost.analyze(flash_attention_ref, q, kv, kv, kv_chunk=SEQ).flops
    assert got.flops == want + attn * cfg.n_layers * mb


def test_flops_scale_with_depth_and_microbatches():
    def prefill(layers):
        return _port_prefill(dataclasses.replace(C.get("qwen3-1.7b").reduced(),
                                                 n_layers=layers)).flops
    f2, f3, f4 = prefill(2), prefill(3), prefill(4)
    assert f4 - f3 == f3 - f2 > 0
    cfg = C.get("qwen3-1.7b").reduced()
    batch = _meta_batch(_ref_batch(cfg, 4, SEQ, train=True))
    key = torch.empty(2, dtype=torch.int64, device="meta")
    flops = []
    for mb in (1, 2, 4):
        ts = TR.build_setup(cfg, microbatches=mb, kv_chunk=SEQ)
        flops.append(op_cost.analyze(ts.step_fn, ts.params_sds, ts.opt_sds, batch, key).flops)
    assert flops[0] == flops[1] == flops[2]     # the same tokens, in 1, 2 or 4 parts


def test_bytes_nonzero_and_scale():
    x = torch.empty((1024, 1024), device="meta")

    def loop(n):
        y = x
        for _ in range(n):
            y = torch.tanh(y)
        return y

    one = op_cost.analyze(loop, 1)
    assert one.hbm_bytes == 2 * 4 * 1024 * 1024 and one.flops == 0
    assert op_cost.analyze(loop, 10).hbm_bytes == 10 * one.hbm_bytes
    with op_cost.OpCost() as oc:
        with op_cost.repeat(10):
            loop(1)
    assert oc.totals.hbm_bytes == 10 * one.hbm_bytes
    assert oc.totals.peak_live_bytes == 4 * 1024 * 1024      # not scaled


def test_repeat_equals_unrolling():
    """A loop of ``n`` equal steps traced once under ``repeated`` counts what
    the loop counts unrolled: FLOPs exactly, forward and backward; bytes
    exactly without autograd (with it, the unrolled loop also adds the
    weight's n per-step gradients, which the one step does not)."""
    w = torch.randn(64, 64, requires_grad=True)
    x0 = torch.randn(32, 64, requires_grad=True)

    def step(x, w):
        return (torch.tanh(x @ w),)

    def unrolled(n):
        x = x0
        for _ in range(n):
            x, = step(x, w)
        return x.sum()

    def once(n):
        x, = cost.repeated(step, n, x0, w)
        return x.sum()

    for n in (1, 5):
        with torch.no_grad():
            a, b = op_cost.analyze(unrolled, n), op_cost.analyze(once, n)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes) == (a.flops, a.hbm_bytes)
        a = op_cost.analyze(lambda: torch.autograd.grad(unrolled(n), [x0, w]))
        b = op_cost.analyze(lambda: torch.autograd.grad(once(n), [x0, w]))
        assert a.flops == b.flops == 3 * n * 2 * 32 * 64 * 64


def test_mamba_scan_repeat_equals_unrolled():
    """Jamba's token loop traced one step a chunk on ``meta`` counts what
    the CPU runs token by token: FLOPs and bytes equal at S 72 (one chunk)
    and 300 (two)."""
    cfg = C.get("jamba-v0.1-52b").reduced()
    for s in (72, 300):
        cpu, meta = _port_prefill(cfg, s=s, device="cpu"), _port_prefill(cfg, s=s)
        assert cpu.flops == meta.flops > 0
        assert cpu.hbm_bytes == meta.hbm_bytes > 0


def test_remat_ratio():
    """A rematerialised train step ~ forward + recompute + 2 x backward."""
    cfg = dataclasses.replace(C.get("qwen3-1.7b").reduced(), remat=True)
    ts = TR.build_setup(cfg, kv_chunk=SEQ)
    batch = _meta_batch(_ref_batch(cfg, B, SEQ, train=True))
    train = op_cost.analyze(ts.step_fn, ts.params_sds, ts.opt_sds, batch,
                            torch.empty(2, dtype=torch.int64, device="meta")).flops
    model = T.build(cfg)
    params = convert.params_view(model, T.abstract_init(model)[0])
    fwd = op_cost.analyze(T.forward, model, params, batch).flops
    assert 3.0 < train / fwd < 5.0, train / fwd


def test_roofline_terms():
    rl = RL.Roofline(flops=PEAK_FLOPS_BF16, hbm_bytes=HBM_BW / 2,
                     collective_bytes=LINK_BW / 4, chips=256)
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s - 0.5) < 1e-9
    assert abs(rl.collective_s - 0.25) < 1e-9
    assert rl.dominant == "compute"
    assert abs(rl.step_time_s - 1.0) < 1e-9
    assert RL.Roofline(flops=PEAK_FLOPS_F32, hbm_bytes=0.0, collective_bytes=0.0, chips=1,
                       peak_flops=PEAK_FLOPS_F32).compute_s == 1.0
    row = rl.row()
    from repro.launch.roofline import Roofline as JRoofline
    assert list(row) == list(JRoofline(1.0, 1.0, 1.0, 1).row())


def test_dominant_switches():
    assert RL.Roofline(0.0, 0.0, LINK_BW, 1).dominant == "collective"
    assert RL.Roofline(0.0, HBM_BW, 0.0, 1).dominant == "memory"


def test_model_flops_and_microbatches_equal_reference():
    ref = _ref_dryrun()
    for arch in C.ALIASES:
        for shape, info in C.SHAPES.items():
            assert dryrun.model_flops(arch, shape) == ref.model_flops(arch, shape)
            for data_total in (1, 16, 32, 256):
                assert dryrun.default_microbatches(C.get(arch), info["batch"], data_total) \
                    == ref.default_microbatches(RC.get(arch), info["batch"], data_total)
    assert dryrun.fmt_b(3 * 2 ** 30) == ref.fmt_b(3 * 2 ** 30)


class _OnlyMeta(TorchDispatchMode):
    """Fails on any op that makes or takes a tensor off the ``meta`` device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pt_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


REF_KEYS = {"arch", "shape", "multi_pod", "status", "roofline", "collectives", "memory",
            "model_flops_6nd", "kind"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", ["host", "16x16"])
def test_run_combo_reduced(shape, mesh):
    m = make_host_mesh() if mesh == "host" else Mesh(("data", "model"), (16, 16))
    with _OnlyMeta():
        res = dryrun.run_combo("qwen3-1.7b", shape, mesh=m, microbatches=1, reduced=True,
                               verbose=False)
    assert res["status"] == "ok", res
    assert REF_KEYS <= set(res) and "trace_s" in res
    assert set(res["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert res["roofline"]["flops_per_dev"] > 0 and res["memory"]["argument_bytes"] > 0
    if mesh == "host":
        assert res["collectives"] == {"bytes": {}, "count": {}}
    else:
        assert res["collectives"]["bytes"]["all-reduce"] > 0


def test_collectives_hand_worked_2x2():
    """(2, 2) mesh, the reduced qwen3 (2 layers, d 128, f32).  Decode at
    batch 128: an all-reduce over ``model`` of each mixer's and FFN's output,
    (128 / 2) x 1 x 128 x 4 B = 32768 B each, 2 x 2 of them.  Prefill at
    batch 32 x 32768: the same 4 all-reduces of (32 / 2) x 32768 x 128 x 4 B."""
    mesh = Mesh(("data", "model"), (2, 2))
    res = dryrun.run_combo("qwen3-1.7b", "decode_32k", mesh=mesh, reduced=True, verbose=False)
    assert res["collectives"] == {"bytes": {"all-reduce": 4 * 32768},
                                  "count": {"all-reduce": 4}}
    res = dryrun.run_combo("qwen3-1.7b", "prefill_32k", mesh=mesh, reduced=True, verbose=False)
    assert res["collectives"] == {"bytes": {"all-reduce": 4 * 16 * 32768 * 128 * 4},
                                  "count": {"all-reduce": 4}}
    assert res["roofline"]["coll_bytes_per_dev"] == 4 * 16 * 32768 * 128 * 4


def test_train_collectives_rule():
    """Train on (2, 2), one microbatch: each ``data``-sharded leaf gathered
    forward and backward and its f32 gradient reduce-scattered; every other
    leaf's gradient all-reduced; the 4 model all-reduces forward and
    backward.  Worked leaf by leaf from the specs."""
    mesh = Mesh(("data", "model"), (2, 2))
    cfg = C.get("qwen3-1.7b").reduced()
    S.set_mesh(mesh)
    try:
        params, specs = T.abstract_init(T.build(cfg))
        specs = T.fsdp_specs(params, specs)
        ag = rs = ar = n_ag = n_rs = n_ar = 0
        for leaf, spec in zip(tree_leaves(params), tree_leaves(specs, is_leaf=S.is_spec)):
            ent = list(spec) + [None] * (leaf.dim() - len(spec))
            split = {ax: 2 if any(e == ax and n % 2 == 0 for e, n in zip(ent, leaf.shape)) else 1
                     for ax in ("data", "model")}
            shard = leaf.numel() // (split["data"] * split["model"])
            if split["data"] == 2:
                ag += 2 * leaf.numel() // split["model"] * leaf.element_size()
                rs += shard * 4
                n_ag, n_rs = n_ag + 2, n_rs + 1
            else:
                ar += shard * 4
                n_ar += 1
    finally:
        S.set_mesh(None)
    res = dryrun.run_combo("qwen3-1.7b", "train_4k", mesh=mesh, reduced=True, microbatches=1,
                           verbose=False)
    act = 2 * 2 * cfg.n_layers * (256 // 2) * 4096 * cfg.d_model * 4     # f32
    assert res["collectives"]["bytes"] == {"all-gather": ag, "reduce-scatter": rs,
                                           "all-reduce": ar + act}
    assert res["collectives"]["count"] == {"all-gather": n_ag, "reduce-scatter": n_rs,
                                           "all-reduce": n_ar + 2 * 2 * cfg.n_layers}


def test_dryrun_main_cpu(tmp_path, capsys):
    """The CLI over one arch, both meshes, the reduced-size trace skipped:
    the full qwen3-1.7b at decode and long context traces in ~2 s."""
    out = tmp_path / "out.json"
    t0 = time.time()
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--both-meshes",
                        "--json", str(out)]) == 0
    assert time.time() - t0 < 60
    assert "2 ok, 0 skipped (documented), 0 FAILED" in capsys.readouterr().out
    assert out.exists()
    skip = dryrun.run_combo("hubert-xlarge", "decode_32k", verbose=False)
    assert skip["status"] == "skip" and "encoder-only" in skip["reason"]


def test_multi_arch_dryrun_example(capsys):
    from repro_torch import multi_arch_dryrun
    res = multi_arch_dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k"])
    assert res["status"] == "ok" and res["kind"] == "decode"
    assert '"dominant"' in capsys.readouterr().out


def test_serve_decode_example_cpu(capsys):
    """The serving example end to end on the CPU, at the reduced size."""
    from repro_torch import serve_decode
    outs = serve_decode.main(["--device", "cpu", "--batch", "2", "--new-tokens", "3"])
    assert [len(o) for o in outs] == [3, 3]
    assert "6 tokens in" in capsys.readouterr().out
