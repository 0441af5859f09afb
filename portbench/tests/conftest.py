"""Tiny sizes of the benchmark's configurations and traffic, for rehearsing
the drivers on the CPU, and the ``card`` fixture of the tests that need one."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402


def _load(kind, name):
    return json.loads((ROOT / "portbench" / kind / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture
def tiny_fl():
    cfg = _load("configs", "fl-mlp-mnist")
    cfg.update(n_train=200, n_test=50, hw=10, widths=[16])
    traffic = _load("traffic", "gr-fixed")
    traffic.update(rounds=4, eval_every=2, judged_jobs=2)
    return cfg, traffic


def tiny_lm(traffic_name):
    cfg = _load("configs", "qwen3-1.7b")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, vocab_size=512,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    traffic = _load("traffic", traffic_name)
    traffic.update(batch=4, seq=32)
    return cfg, traffic


def rehearse(driver, cfg, traffic, seed=2 ** 31 + 99, seconds=0.5):
    """One run of ``driver`` on the CPU, the harness's look for a card skipped."""
    return driver.run(cfg, traffic, seed=seed, seconds=seconds, trace=False, device="cpu",
                      t_start=0.0, log=lambda msg: None)
