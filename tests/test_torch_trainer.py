"""The trainer's pieces: ``launch/train.py::train_loop`` (restart from a
checkpoint replays exactly), the watchdog and elastic planning
(``distributed/fault_tolerance.py``), the data pipeline (``data/
pipeline.py``: batches bit for bit the reference's), gradient compression
(``distributed/compression.py``) and ``checkpoint/ckpt.py::latest_step``.

The reference's cases (``tests/test_fault_tolerance.py``,
``tests/test_data_pipeline.py``, ``tests/test_compression.py`` but its mesh
collective) are mirrored on the port, with its tolerances: the replay at
1e-6 / 1e-5 relative, compression's error-feedback mean at 2e-3.  Where a
reference check asserts, the port raises ``ValueError``.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.distributed import compression as jcomp
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline, pipeline_for
from repro_torch.distributed import compression as comp
from repro_torch.distributed.fault_tolerance import (RestartLog,
                                                     StepWatchdog,
                                                     elastic_data_axis)
from repro_torch.launch import steps as steplib
from repro_torch.launch import train
from repro_torch.optim import adam

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _hp(steps):
    return steplib.HParams(remat="none", optimizer=adam.AdamWConfig(
        lr=1e-3, total_steps=steps, warmup_steps=2))


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

def test_checkpoint_restart_replays_exactly(tmp_path):
    """Train 6 straight vs 3 + stop + resume 3: identical loss history
    (deterministic data replay + exact state restore)."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    shape = ShapeConfig("t", "train", 32, 4)
    _, hist_full = train.train_loop(cfg, shape, _hp(6), steps=6,
                                    log_every=0, device="cpu")
    ckdir = str(tmp_path / "ck")
    _, hist_a = train.train_loop(cfg, shape, _hp(6), steps=3,
                                 ckpt_dir=ckdir, ckpt_every=3, log_every=0,
                                 resume=False, device="cpu")
    assert ckpt.latest_step(ckdir) == 3
    _, hist_b = train.train_loop(cfg, shape, _hp(6), steps=6,
                                 ckpt_dir=ckdir, ckpt_every=100, log_every=0,
                                 resume=True, device="cpu")
    assert len(hist_a) == 3 and len(hist_b) == 3
    np.testing.assert_allclose(hist_full[:3], hist_a, rtol=1e-6)
    np.testing.assert_allclose(hist_full[3:], hist_b, rtol=1e-5)


def test_checkpoint_every_step_holds_its_own_step(tmp_path, monkeypatch):
    """The train step updates the state in place while the async writer
    saves: with a checkpoint after each of 3 steps and a writer that starts
    late, each ``step_N`` restores bit for bit to the state after N steps
    of an unbroken run, and its checksums hold."""
    cfg = get_config("qwen3-8b").reduced()
    shape = ShapeConfig("t", "train", 16, 2)
    real = ckpt.save

    def late_save(*a, **kw):
        time.sleep(0.3)                 # the next step runs meanwhile
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save", late_save)
    ckdir = str(tmp_path / "ck")
    train.train_loop(cfg, shape, _hp(3), steps=3, ckpt_dir=ckdir,
                     ckpt_every=1, log_every=0, resume=False, device="cpu")
    assert ckpt.latest_step(ckdir) == 3
    for n in (1, 2, 3):
        want, _ = train.train_loop(cfg, shape, _hp(3), steps=n,
                                   log_every=0, device="cpu")
        got, step = ckpt.restore(want, os.path.join(ckdir, f"step_{n}"))
        assert step == n
        for (k, w), (_, g) in zip(ckpt.tree_items(want),
                                  ckpt.tree_items(got)):
            assert np.array_equal(ckpt.host_array(w), g), (n, k)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "deepseek-moe-16b"])
def test_train_loop_runs_every_family(arch):
    """A few steps through the normal entry point (the token pipeline
    feeds no image embeddings, so the VLM trains through
    ``build_train_step`` only, as in the reference); ``on_step`` sees every
    step's metrics as floats."""
    cfg = get_config(arch).reduced()
    seen = []
    _, hist = train.train_loop(
        cfg, ShapeConfig("t", "train", 16, 2), _hp(4), steps=4,
        log_every=0, device="cpu",
        on_step=lambda s, m, sec: seen.append((s, m, sec)))
    assert [s for s, _, _ in seen] == [0, 1, 2, 3]
    assert all(set(m) == {"loss", "grad_norm", "lr"} and sec > 0 and
               all(np.isfinite(v) for v in m.values()) for _, m, sec in seen)
    assert hist == [m["loss"] for _, m, _ in seen]


def test_train_main_cli(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU, reduced config,
    checkpoints every 2 steps."""
    from repro_torch.obs import log
    log.set_level("info")
    try:
        train.main(["--arch", "qwen3-8b", "--steps", "4", "--batch", "2",
                    "--seq", "16", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "2", "--device", "cpu"])
    finally:
        log.set_level(None)
    out = capsys.readouterr().out
    assert "[train] step step=0" in out and "[train] done" in out
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_mesh_is_none_on_one_device():
    assert train.make_mesh_if_possible(device="cpu") is None


def test_training_runs_without_jax(tmp_path):
    """The trainer in a fresh interpreter: neither JAX nor the reference
    package is imported."""
    code = f"""
import sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import steps, train
cfg = get_config("qwen3-8b").reduced()
_, hist = train.train_loop(cfg, ShapeConfig("t", "train", 16, 2),
                           steps.HParams(), steps=2, log_every=0,
                           ckpt_dir={str(tmp_path)!r}, ckpt_every=1,
                           device="cpu")
assert len(hist) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    for d in ("step_3", "step_12", "step_x", "other"):
        os.makedirs(tmp_path / d)
    (tmp_path / "step_40").write_text("a file, not a checkpoint")
    assert ckpt.latest_step(str(tmp_path)) == 12


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    wd = StepWatchdog(straggler_ratio=2.0, demote_after=2)
    for step in range(6):
        wd.start_step(step)
        time.sleep(0.01)
        assert wd.end_step() is None
    for step in range(6, 8):
        wd.start_step(step)
        time.sleep(0.05)
        ev = wd.end_step()
        assert ev is not None and ev.ratio > 2.0
    assert wd.should_remesh()
    plan = wd.plan(n_hosts=8)
    assert plan["action"] == "remesh" and plan["healthy_hosts"] == 7


def test_watchdog_hang_detection():
    wd = StepWatchdog(hang_timeout=2.0)
    for step in range(4):
        wd.start_step(step)
        time.sleep(0.01)
        wd.end_step()
    wd.start_step(99)
    time.sleep(0.05)
    assert wd.check_hang()
    with pytest.raises(RuntimeError):
        StepWatchdog().end_step()


def test_elastic_data_axis():
    assert elastic_data_axis(512, 16) == 32
    assert elastic_data_axis(480, 16) == 30    # 2 hosts of 16 lost
    with pytest.raises(ValueError):
        elastic_data_axis(8, 16)
    log = RestartLog()
    log.record(step=3, reason="hang", old_devices=8, new_devices=4)
    assert log.restarts[0]["old"] == 8 and log.restarts[0]["new"] == 4


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zipf", "copy"])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_equal_reference(kind, hosts):
    """Every host's shard of every step, bit for bit the reference's."""
    for vocab, seq, batch, seed in ((1000, 32, 8, 1), (151936, 17, 4, 7)):
        cfg = DataConfig(vocab, seq, batch, seed=seed, kind=kind)
        jcfg = jpipe.DataConfig(vocab, seq, batch, seed=seed, kind=kind)
        for h in range(hosts):
            mine = TokenPipeline(cfg, hosts, h)
            ref = jpipe.TokenPipeline(jcfg, hosts, h)
            for step in (0, 3, 17):
                a, b = mine.batch_at(step), ref.batch_at(step)
                assert set(a) == set(b) == {"tokens", "labels"}
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k])


def test_deterministic_replay_and_steps_differ():
    cfg = DataConfig(1000, 32, 8, seed=1)
    np.testing.assert_array_equal(TokenPipeline(cfg).batch_at(17)["tokens"],
                                  TokenPipeline(cfg).batch_at(17)["tokens"])
    p = TokenPipeline(cfg)
    assert not np.array_equal(p.batch_at(0)["tokens"],
                              p.batch_at(1)["tokens"])


def test_host_shards_partition_global_batch():
    cfg = DataConfig(1000, 16, 8, seed=3)
    whole = TokenPipeline(cfg, n_hosts=1, host_id=0).batch_at(5)["tokens"]
    parts = [TokenPipeline(cfg, n_hosts=4, host_id=h).batch_at(5)["tokens"]
             for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    two = np.concatenate([TokenPipeline(cfg, 2, h).batch_at(11)["tokens"]
                          for h in range(2)])
    eight = np.concatenate([TokenPipeline(cfg, 8, h).batch_at(11)["tokens"]
                            for h in range(8)])
    np.testing.assert_array_equal(two, eight)
    with pytest.raises(ValueError):
        TokenPipeline(cfg, n_hosts=3)


def test_labels_copy_task_and_state():
    b = TokenPipeline(DataConfig(100, 16, 2, seed=0)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b = TokenPipeline(DataConfig(50, 15, 2, seed=0, kind="copy")).batch_at(0)
    row = np.concatenate([b["tokens"][0], b["labels"][0, -1:]])
    half = len(row) // 2
    np.testing.assert_array_equal(row[half:2 * half], row[:half])
    cfg = DataConfig(100, 8, 2)
    p = TokenPipeline(cfg)
    next(p)
    next(p)
    q = TokenPipeline(cfg)
    q.load_state_dict(p.state_dict())
    np.testing.assert_array_equal(next(p)["tokens"], next(q)["tokens"])
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(10, 4, 2, kind="other")).batch_at(0)
    pipe = pipeline_for(get_config("qwen3-8b").reduced(),
                        ShapeConfig("t", "train", 12, 4), seed=2)
    assert pipe.batch_at(0)["tokens"].shape == (4, 12)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_bounds_and_reference():
    x = np.random.default_rng(0).standard_normal((128, 64)).astype(
        np.float32) * 5
    q, s = comp._quantize(torch.from_numpy(x))
    err = (comp._dequantize(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6
    jq, js = jcomp._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_preserves_mean_signal():
    g_true = torch.from_numpy(np.random.default_rng(1).standard_normal(
        256).astype(np.float32) * 0.1)
    ef = torch.zeros(256)
    total = torch.zeros(256)
    for _ in range(50):
        out, ef = comp.compress_grads(g_true, ef)
        total = total + out
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=2e-3)


def test_compress_grads_trees_match_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((8, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
        g["b"]["c"])}}
    ef = comp.init_error_feedback(tg)
    assert ef["b"]["c"].dtype == torch.float32 and not ef["a"].any()
    out, ef2 = comp.compress_grads(tg, ef)
    jout, jef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g),
                                     jcomp.init_error_feedback(g))
    for got, want in ((out["a"], jout["a"]), (out["b"]["c"],
                                              jout["b"]["c"]),
                      (ef2["a"], jef["a"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_compression_ratio_and_psum():
    grads = {"a": torch.zeros(1024), "b": torch.zeros(2048)}
    r = comp.compression_ratio(grads)
    assert 3.9 < r < 4.0
    assert r == jcomp.compression_ratio({"a": jnp.zeros(1024),
                                         "b": jnp.zeros(2048)})
    with pytest.raises(NotImplementedError, match="item 12"):
        comp.compressed_psum(torch.zeros(4), "data")
