"""Nothing a run loads is JAX or the JAX package, the reference loads nothing
of the port, and a run without a card prints no result."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PRELUDE = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]; "
           "import torch; torch.set_num_threads(2); ")


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_rehearsed_run_loads_no_jax():
    code = ("sys.path.insert(0, 'portbench/tests'); from conftest import rehearse, tiny_lm; "
            "import conftest; from portbench.drivers import fl_jobs, train_steps; "
            "from portbench import run, harness; "
            "cfg, tr = conftest.tiny_lm('train-sign'); rehearse(train_steps, cfg, tr); "
            "import json; c = json.load(open('portbench/configs/fl-mlp-mnist.json')); "
            "c.update(n_train=200, n_test=50, hw=10, widths=[16]); "
            "t = json.load(open('portbench/traffic/gr-fixed.json')); "
            "t.update(rounds=2, eval_every=1, judged_jobs=1); rehearse(fl_jobs, c, t); "
            "print(json.dumps(run.forbidden_modules()))")
    assert json.loads(_python(code)) == []


def test_the_references_load_nothing_of_the_port():
    code = ("import portbench.reference.fl_mask, portbench.reference.qwen3_train, "
            "portbench.yardstick.trace, portbench.yardstick.peaks, portbench.yardstick.fl_data, "
            "portbench.yardstick.lm_params, portbench.yardstick.lm_stream; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(json.loads(_python(code)))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_the_whole_top_level_name(monkeypatch):
    from portbench import run
    for name in ("repro_torch.fl", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.fl", sys)
    assert run.forbidden_modules() == ["jax.numpy", "repro.fl"]


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fl-mlp.gr-fixed",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
