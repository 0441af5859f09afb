"""The yardstick's frozen copies give the port's bits at fixed seeds today:
the threefry draws, the FL inputs, the LM token stream and the attention
forward's work."""
import math

import numpy as np
import pytest
import torch

from portbench.yardstick import fl_data, lm_stream, peaks
from portbench.yardstick import threefry as tf

SEEDS = (0, 7, 2 ** 31 + 12345)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_draws_are_the_ports(seed):
    from repro_torch import prng
    k, pk = tf.key(seed, "cpu"), prng.PRNGKey(seed, device="cpu")
    assert torch.equal(k, pk)
    assert torch.equal(tf.fold_in(k, 5), prng.fold_in(pk, 5))
    assert torch.equal(tf.split(k, (3, 2)), prng.split(pk, (3, 2)))
    ids = torch.arange(6)
    assert torch.equal(tf.fold_in(k[None], ids), prng.fold_in(pk[None], ids))
    assert torch.equal(tf.uniform(tf.split(k, 4), (5, 7)), prng.uniform(prng.split(pk, 4), (5, 7)))
    at = torch.arange(100, 300, dtype=torch.int64)
    assert torch.equal(tf.uniform_at(k, at), prng.uniform_at(pk, at))
    assert torch.equal(tf.randint(k, (4, 9), 0, 200), prng.randint(pk, (4, 9), 0, 200))
    assert torch.equal(tf.normal(k, (33,)), prng.normal(pk, (33,)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fl_inputs_are_the_quickstarts_draws(seed):
    from repro_torch import prng
    from repro_torch.fl.data import make_synthetic, partition_iid
    from repro_torch.fl.nets import flatten_weights, make_mlp
    cfg = dict(n_train=200, n_test=50, hw=10, noise=0.4, n_classes=10, n_clients=10,
               widths=[16])
    got = fl_data.make_inputs(seed, cfg, "cpu")
    key = prng.PRNGKey(seed, device="cpu")
    train, test = make_synthetic(key, n_train=200, n_test=50, hw=10, noise=0.4, device="cpu")
    shards = partition_iid(prng.fold_in(key, 1), train, 10, 20)
    net = make_mlp(in_dim=100, widths=(16,), signed_constant=True, device="cpu")
    w0, _ = flatten_weights(net.init(prng.fold_in(key, 2)))
    for a, b in ((got["x"], shards.x), (got["y"], shards.y), (got["x_test"], test.x),
                 (got["y_test"], test.y), (got["w0"], w0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_token_stream_is_the_ports(seed):
    from repro_torch.data import TokenPipeline
    ours = lm_stream.TokenStream(151936, seed).stream(2, 40)
    theirs = TokenPipeline(151936, seed=seed).stream(2, 40)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("shape", [(2, 1024, 16, 8, 128, True), (1, 300, 4, 4, 80, False),
                                   (2, 77, 4, 2, 8, True)])
def test_attention_work_is_the_ports_cost(shape):
    from repro_torch.kernels import cost
    b, s, h, hk, dh, causal = shape
    q = torch.empty(b, s, h, dh, dtype=torch.float32, device="meta")
    k = torch.empty(b, s, hk, dh, dtype=torch.float32, device="meta")
    work = cost.flash_attention(q, k, k, causal, 0)
    assert peaks.attention_work(b, s, s, h, hk, dh, causal, 4) == (work.flops, work.nbytes)


def test_peaks_and_name_rules():
    assert peaks.PEAK_FLOPS == 989e12 and peaks.PEAK_BYTES == 3.35e12
    assert peaks.is_own_fl_kernel("void mrc_encode_kernel<32, true>(...)")
    assert peaks.is_flash_fwd("void tf32::flash_attn_tf32<128>(...)")
    assert peaks.is_gemm("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32")
    assert peaks.is_gemm("nvjet_tst_128x64_64x8_1x2_h_bz_TNT")
    assert not peaks.is_gemm("void tf32::flash_attn_tf32<128>(...)")
    assert not peaks.is_gemm("void at::native::vectorized_elementwise_kernel<4>")
    assert math.isclose(peaks.bound_seconds(989e12, 0), 1.0)
