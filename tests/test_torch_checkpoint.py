"""The port's checkpoints, straggler tracking and training driver
(``repro_torch.distributed``, ``repro_torch.launch.train``), on the CPU.

Checkpoints round-trip bitwise (f32 and bf16 leaves alike: bf16 is
stored as its bit pattern).  ``StragglerMitigator`` gives the reference's
flags on the same step times.  The driver resumes as the reference's
``tests/test_launch.py::test_train_checkpoint_resume`` does.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.distributed.fault_tolerance import StragglerMitigator
from repro_torch.launch.train import main, train
from repro_torch.train import init_train_state


def _state(dtype="float32", seed=0):
    cfg = dataclasses.replace(tbase.reduced_config("stablelm-1.6b"),
                              dtype=dtype)
    st = init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    with torch.no_grad():
        for v in st.opt.mu.values():
            v.normal_(generator=torch.Generator().manual_seed(seed + 1))
    st.opt.count.fill_(7)
    st.step.fill_(7)
    return st


def _flat(st):
    return {k: v.detach().clone() for k, v in ckpt._flatten(st).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_restore_round_trip(tmp_path, dtype):
    src, dst = _state(dtype, seed=0), _state(dtype, seed=5)
    want = _flat(src)
    path = ckpt.save(str(tmp_path), src, 7)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7
    assert manifest["leaves"]["model/embed"]["dtype"] == dtype
    assert manifest["leaves"]["opt/mu/embed"]["dtype"] == "float32"
    assert "model/blocks.0.attn.wq" in manifest["leaves"]
    assert "step" in manifest["leaves"] and "opt/count" in manifest["leaves"]
    out, step = ckpt.restore(str(tmp_path), dst)
    assert out is dst and step == 7
    got = _flat(dst)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_restore_rejects_a_shape_mismatch_and_shardings(tmp_path):
    """A leaf of another shape; shardings that miss a leaf or do not split
    it (the resharding round trip itself is in
    ``test_torch_sharded_train.py``)."""
    ckpt.save(str(tmp_path), {"w": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4)})
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="no sharding"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3)}, shardings={})
    with pytest.raises(ValueError, match="split"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3)},
                     shardings={"w": NamedSharding(mesh, P("data"))})
    out, _ = ckpt.restore(str(tmp_path), {"w": torch.ones(3)},
                          shardings={"w": NamedSharding(mesh, P())})
    assert torch.equal(out["w"], torch.zeros(3))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"w": torch.zeros(3)})


def test_async_save_gc_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    writer = ckpt.AsyncCheckpointer()
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    for step in (1, 2, 3, 4, 5):
        tree["w"].add_(1.0)
        writer.save(d, tree, step)
    writer.wait()
    assert sorted(os.listdir(d)) == [f"step_{s:010d}" for s in (3, 4, 5)]
    assert ckpt.latest_step(d) == 5
    back = {"w": torch.zeros(6)}
    ckpt.restore(d, back, step=4)
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32) + 4)
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert ckpt.latest_step(d) == 5          # a partial save is ignored


def test_straggler_mitigator_matches_jax():
    hosts = ["a", "b", "c"]
    mine = StragglerMitigator(hosts, patience=2)
    ref = jft.StragglerMitigator(hosts, patience=2)
    rng = np.random.default_rng(0)
    for step in range(12):
        for h in hosts:
            t = float(rng.uniform(0.9, 1.1)) * (3.0 if h == "c" and
                                                 step > 3 else 1.0)
            mine.record(h, t)
            ref.record(h, t)
        assert mine.stragglers() == ref.stragglers()
        assert mine.ema == ref.ema and mine.flags == ref.flags
    assert mine.stragglers() == ["c"]
    assert StragglerMitigator(["x"]).stragglers() == []


def test_train_checkpoint_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    # run 1: 12 steps, checkpoint every 5
    losses1 = train("stablelm-1.6b", steps=12, batch=2, seq=32,
                    ckpt_dir=d, ckpt_every=5, base_lr=1e-3,
                    profile_data=False, log_every=100, device="cpu")
    assert len(losses1) == 12
    assert ckpt.latest_step(d) == 12
    # run 2: resume from the final checkpoint, 6 more steps
    losses2 = train("stablelm-1.6b", steps=18, batch=2, seq=32,
                    ckpt_dir=d, resume=True, base_lr=1e-3,
                    profile_data=False, log_every=100, device="cpu")
    assert 0 < len(losses2) <= 6
    assert np.isfinite(losses1 + losses2).all()
    # resumed losses continue from trained state, not from scratch
    assert losses2[0] < losses1[0]


def test_train_main_runs_on_the_cpu_and_needs_a_card_by_default(capsys):
    losses = main(["--steps", "3", "--batch", "2", "--seq", "16",
                   "--device", "cpu"])
    assert len(losses) == 3
    out = capsys.readouterr().out
    assert "[data] distinct-token estimate" in out and "final loss" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train("stablelm-1.6b", steps=1)
