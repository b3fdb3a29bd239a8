"""The port's learning demo (`horopose_tpu_torch/scripts/demo_learn.py`)
and the memorization regression, on the CPU.

- the demo's YAML, read by the port's `make_cfg` and by the JAX
  `make_cfg`, gives equal values for every key both know, against the
  JAX demo's template read from `scripts/demo_learn.py` with `ast`
  (without running it);
- `demo_learn.main` at a tiny size (resnet18 backbones, 4 + 2 rendered
  96x128 frames, one epoch at b=2) prints the progression and the
  no-best-checkpoint line (a 1-epoch model's ADD AUC is 0), and with a
  best checkpoint written after training, the harness replay's
  summary.txt;
- the memorization regression of `tests/test_auc_regression.py`
  (`chip_smoke.memorization_run`, which phase 14 (a) runs on the card),
  marked slow as its JAX twin is: the batch-statistics ADD AUC reaches
  0.70 and the running-statistics one 0.15.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.scripts import demo_learn

from test_torch_port_pipelines import _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--backbone", "resnet18", "--rootnet-backbone",
        "resnet18", "--n-train", "4", "--n-test", "2", "--epochs", "1",
        "--batch-size", "2", "--image-hw", "96", "128"]
ROW = re.compile(r"^\s+epoch\s+(\d+): loss=(\S+)", re.M)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_template() -> str:
    with open(os.path.join(REPO, "scripts", "demo_learn.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "CONFIG_TEMPLATE"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no CONFIG_TEMPLATE in scripts/demo_learn.py")


@pytest.mark.parametrize("epochs", [4, 30])
def test_demo_config_reads_as_the_jax_demo_config(epochs, tmp_path):
    """The two templates, filled with the demo's defaults, read as the
    same config by both packages' make_cfg."""
    values = dict(exp_name="demo_learn", robot="panda",
                  backbone="resnet50", rootnet_backbone="hrnet32", lr=1e-4,
                  batch_size=32, epoch_size=512, epochs=epochs,
                  use_schedule=epochs > 20,
                  start_decay=max(epochs // 2, 1), end_decay=epochs)
    ours_path = tmp_path / "ours.yaml"
    ref_path = tmp_path / "ref.yaml"
    ours_path.write_text(demo_learn.CONFIG_TEMPLATE.format(**values))
    ref_path.write_text(_jax_template().format(**values))
    ours, ref = make_cfg(str(ours_path)), jax_make_cfg(str(ref_path))
    shared = (set(ours) & set(ref)) - {"config_path"}
    assert len(shared) > 100
    for k in sorted(shared):
        _same(ours[k], ref[k], k)
    assert ours.n_epochs == epochs and ours.batch_size == 32


def _run_tiny(tmp_path, capsys):
    demo_learn.main(["--workdir", str(tmp_path / "demo"), *TINY])
    return capsys.readouterr().out


def test_demo_runs_and_prints_its_progression(tmp_path, capsys, one_thread):
    out = _run_tiny(tmp_path, capsys)
    rows = ROW.findall(out)
    assert [int(e) for e, _ in rows] == [0], out
    assert np.isfinite(float(rows[0][1]))
    assert "dr=" in out and "err3d_dr=" in out and "depth_dr=" in out
    assert "no best checkpoint was saved" in out, out
    # a second run finds its sets and does not render them again
    out = _run_tiny(tmp_path, capsys)
    assert "datasets already generated" in out


def test_demo_replays_the_harness_on_the_best_checkpoint(tmp_path, capsys,
                                                         monkeypatch,
                                                         one_thread):
    """A 1-epoch model scores 0, which the keeper never saves: write the
    best-AUC checkpoint after training, as tests/test_e2e_train.py does,
    and the demo replays test_network on it."""
    from horopose_tpu_torch.core.checkpoint import save_checkpoint_file
    from horopose_tpu_torch.pipelines import train_full as TF

    real = TF.train_full

    def train_and_keep(cfg, **kw):
        state = real(cfg, **kw)
        save_checkpoint_file(
            os.path.join(kw["exp_root"], cfg.exp_name, "ckpt",
                         demo_learn.BEST_CKPT),
            epoch=0, metric=0.0, state=state)
        return state
    monkeypatch.setattr(TF, "train_full", train_and_keep)
    out = _run_tiny(tmp_path, capsys)
    assert ROW.findall(out), out
    assert "[demo] result/summary.txt:" in out, out
    summary = out.split("[demo] result/summary.txt:", 1)[1]
    assert "ADD" in summary and "AUC" in summary


@pytest.mark.slow
def test_add_auc_crosses_threshold(tmp_path):
    """tests/test_auc_regression.py in the port: 4 noise frames with eval
    = train, resnet18 backbones at 64x64, b=4, up to 450 one-step epochs;
    the batch-statistics ADD AUC must reach 0.70 and the running-statistics
    one 0.15 (bounded by the unbiased running variance at this size, as
    the JAX test's docstring says)."""
    run = chip_smoke.memorization_run(str(tmp_path), torch.device("cpu"))
    assert max(run["aucs_batch_stats"].values()) >= \
        chip_smoke.MEMO_BATCH_STATS_AUC, run
    assert max(run["aucs"].values()) >= chip_smoke.MEMO_RUNNING_AUC, run
    assert np.isfinite(run["loss_last"])
