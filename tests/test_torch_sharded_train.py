"""The sharded train step (with its tensor-parallel split over "model"),
``compressed_psum`` and the elastic restore on gloo ranks
(``tests/test_sharding.py``, ``tests/test_compression.py``,
``tests/test_checkpoint.py`` mesh cases).

Each case runs in fresh interpreters, one per rank
(``test_torch_sharding.run_ranks``), with torch alone: every rank builds
the same state and batch from the same seeds and holds the sharded result
to the one-rank result it computes itself, at the reference's tolerances
(loss rtol 1e-5, grad norm rtol 1e-4; ``compressed_psum`` within
4·scale + 1e-5; restored values equal).  The one-rank step itself is held
to the reference in ``test_torch_train.py``.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_config
from repro_torch.launch import steps
from test_torch_sharding import run_ranks

_MODEL = """
import collections
import dataclasses
import numpy as np
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import zoo
from repro_torch.models.template import tree_map
from repro_torch.optim import adam

cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                          compute_dtype="float32")
hp = steps.HParams(remat="none", optimizer=adam.AdamWConfig(
    warmup_steps=2, total_steps=10))
copy = lambda st: {"params": tree_map(torch.clone, st["params"]),
                   "opt": tree_map(torch.clone, st["opt"]),
                   "step": st["step"].clone()}
state = steps.init_state(cfg, 0, device="cpu")
state["step"] = torch.tensor(1, dtype=torch.int32)  # lr > 0 after warmup 0
batch = zoo.make_inputs(cfg, 4, 3, seq=32, device="cpu")
batch["labels"] = torch.from_numpy(np.random.default_rng(9).integers(
    0, cfg.vocab_size, (4, 32)))
"""


# the sequence split of a 2 x 2 ("data", "model") mesh (``seq_parallel``),
# a batch placed at its ``batch_specs`` (each rank [2, S/2]): the train
# step's loss within rtol 1e-5, its grad norm within rtol 1e-4, the moments
# and, where the gradient is resolved, the updated parameters within rtol
# 2e-4 / atol 1e-6 of one rank's (``one``, ``m1``; elsewhere within the two
# AdamW steps of 2 lr, as ``test_torch_train.py`` holds them), and the
# prefill's last logits and cache within 1e-5; every
# attention kernel call on the whole sequence and every ``ssd_scan`` call on
# all its chunks, every norm of the residual stream on the rank's rows and
# sequence block [2, S/2, D]
SP_CASE = """
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L

sp_seen = collections.defaultdict(set)
_kernel, _norm, _scan = fa.flash_attention, L.rms_norm, L.ssd_scan


def _attn_spy(q, *a, **k):
    sp_seen["attn"].add(q.shape[1])
    return _kernel(q, *a, **k)


def _norm_spy(x, w, eps=1e-5):
    sp_seen["norm"].add(tuple(x.shape))
    return _norm(x, w, eps)


def _scan_spy(states, decay):
    sp_seen["chunks"].add(states.shape[1])
    return _scan(states, decay)


fa.flash_attention, L.rms_norm, L.ssd_scan = _attn_spy, _norm_spy, _scan_spy


def sp_case(cfg, h, st, b, mesh, one, m1):
    B, S = b["labels"].shape
    pol = shd.ShardingPolicy(mesh, seq_parallel=True)
    specs = steps.batch_specs(cfg, ShapeConfig("t", "train", S, B), pol)
    placed = steps.place(b, specs, mesh)
    assert tuple(placed["labels"].to_local().shape) == (B // 2, S // 2)
    sp_seen.clear()
    new, m2 = steps.build_train_step(cfg, h, pol)(
        steps.place_state(copy(st), cfg, pol), placed)
    D = cfg.d_model
    assert {s for s in sp_seen["norm"] if s[-1] == D} == \\
        {(B // 2 // h.accum, S // 2, D)}, sp_seen["norm"]
    assert sp_seen["attn"] <= {S}, sp_seen["attn"]
    assert sp_seen["chunks"] <= {S // cfg.ssm_chunk}, sp_seen["chunks"]
    assert sp_seen["attn"] or sp_seen["chunks"], cfg.name
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5, err_msg=cfg.name)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4,
                               err_msg=cfg.name)
    mu, lr = dict(tree_items(one["opt"]["mu"])), float(m1["lr"])
    for group in ("params", "opt"):
        for (k, x), y in zip(tree_items(one[group]),
                             steps._leaves(new[group])):
            y = y.full_tensor()
            if group == "params":
                # AdamW moves an element by about lr, whatever its
                # gradient's size: where the gradient is not resolved
                # (below 1e-3 of the leaf's largest) only that bound holds
                assert float((y - x).abs().max()) <= 2 * lr, (cfg.name, k)
                ok = mu[k].abs() >= 1e-3 * mu[k].abs().max()
                x, y = x[ok], y[ok]
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=f"{cfg.name} {k}")
    params = tree_map(torch.clone, st["params"])
    pb = {k: v for k, v in b.items() if k != "labels"}
    want_l, want_c = steps.build_prefill_step(cfg, h)(params, pb)
    specs = steps.batch_specs(cfg, ShapeConfig("p", "prefill", S, B), pol)
    sp_seen.clear()
    got_l, got_c = steps.build_prefill_step(cfg, h, pol)(
        steps.place(params, steps.param_specs(cfg, pol), mesh),
        steps.place(pb, specs, mesh))
    assert {s for s in sp_seen["norm"] if s[-1] == D} == \\
        {(B // 2, S // 2, D)}, sp_seen["norm"]
    assert sp_seen["attn"] <= {S} and sp_seen["chunks"] <= \\
        {S // cfg.ssm_chunk}, sp_seen
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=cfg.name)
    for (k, x), (_, y) in zip(tree_items(want_c), tree_items(got_c)):
        np.testing.assert_allclose(y.full_tensor().numpy(), x.numpy(),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{cfg.name} {k}")
    return float(m2["loss"])
"""


def test_sharded_train_step_matches_one_rank():
    """Reduced qwen3 in fp32 on a 2 x 2 ("data", "model") mesh: the loss
    within rtol 1e-5 and the grad norm within rtol 1e-4 of one rank, the
    updated parameters and moments the one-rank ones, each rank holding
    its blocks, with the batch split by rows and, under ``seq_parallel``,
    along the sequence too (``SP_CASE``); then the sharded prefill and
    decode steps return the one-rank logits, cache and tokens."""
    outs = run_ranks(_MODEL + SP_CASE + """
from torch.distributed.tensor import DTensor
one, m1 = steps.build_train_step(cfg, hp)(copy(state), batch)
mesh = shd.make_mesh((2, 2), ("data", "model"))
pol = shd.ShardingPolicy(mesh)
placed = steps.place_state(copy(state), cfg, pol)
emb = placed["params"]["embed"]
assert isinstance(emb, DTensor)
assert tuple(emb.to_local().shape) == tuple(
    s // 2 for s in state["params"]["embed"].shape)
new, m2 = steps.build_train_step(cfg, hp, pol)(placed, batch)
np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                           rtol=1e-4)
assert int(new["step"]) == 2 and new is placed
# seq_parallel: a plain full batch and DTensors at its batch_specs give
# one layout, the rank's rows and sequence block (SP_CASE)
hp_sp = dataclasses.replace(hp, seq_parallel=True)
_, m3 = steps.build_train_step(cfg, hp_sp, pol)(
    steps.place_state(copy(state), cfg, pol), batch)
np.testing.assert_allclose(float(m3["loss"]), float(m1["loss"]), rtol=1e-5)
sp_case(cfg, hp, state, batch, mesh, one, m1)
for group in ("params", "opt"):
    a = steps._leaves(one[group]); b = steps._leaves(new[group])
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.full_tensor().numpy(), x.numpy(),
                                   rtol=2e-4, atol=1e-6)

# prefill and decode: rows split over "data", the cache at cache_specs
# (its sequence over "model": one kv head), the logits and tokens whole
params = tree_map(torch.clone, state["params"])
pl = steps.place_state(copy(state), cfg, pol)["params"]
pb = {"tokens": batch["tokens"]}
want_l, want_c = steps.build_prefill_step(cfg, hp)(params, pb)
got_l, got_c = steps.build_prefill_step(cfg, hp, pol)(pl, pb)
np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-5,
                           atol=1e-5)
for (k, x), (_, y) in zip(tree_items(want_c),
                          tree_items(got_c)):
    assert isinstance(y, DTensor) and y.to_local().numel() * 4 == x.numel()
    np.testing.assert_allclose(y.full_tensor().numpy(), x.numpy(),
                               rtol=1e-5, atol=1e-5)
cache = zoo.init_cache(cfg, 4, 40, device="cpu")
cache2 = steps.place(zoo.init_cache(cfg, 4, 40, device="cpu"),
                     steps.cache_specs(cfg, pol, cache), pol.mesh)
tok = batch["tokens"][:, 0]
for pos in range(3):
    t1, _ = steps.build_serve_step(cfg, hp)(params, cache, tok, pos)
    t2, _ = steps.build_serve_step(cfg, hp, pol)(pl, cache2, tok, pos)
    assert torch.equal(t1, t2), (t1, t2)
    for (k, x), (_, y) in zip(tree_items(cache),
                              tree_items(cache2)):
        np.testing.assert_allclose(y.full_tensor().numpy(), x.numpy(),
                                   rtol=1e-5, atol=1e-5)
    tok = t1
print("SHARDED_OK", float(m1["loss"]), float(m2["loss"]))
""", 4)
    assert all(o.startswith("SHARDED_OK") for o in outs)


@pytest.mark.parametrize("remat,accum", [("none", 1), ("dots", 1),
                                         ("full", 1), ("dots", 2)])
def test_block_step_matches_one_rank(remat, accum):
    """The 2 x 2 ("data", "model") step that holds shards: each layer's
    blocks gathered inside its (recomputed) function, the gradients
    reduce-scattered into the blocks, the norm summed over the blocks,
    AdamW on the blocks.  Under remat "none", "dots" and "full" and with
    2 microbatches (reduced qwen3, fp32, its kv head replicated over
    "model"): loss rtol 1e-5, grad norm rtol 1e-4 and the parameters and
    moments after AdamW within 1e-5 of one rank's; no rank holds more
    than its blocks, and the backward moves the gradients by
    reduce-scatter."""
    outs = run_ranks(_MODEL + f"""
from torch.distributed.tensor import DTensor
calls = collections.Counter()
real = shd._fc()


class Spy:
    # the functional collectives, each call counted
    def __getattr__(self, name):
        def call(*args):
            calls[name] += 1
            return getattr(real, name)(*args)
        return call


shd._fc = Spy
h = dataclasses.replace(hp, remat={remat!r}, accum={accum})
one, m1 = steps.build_train_step(cfg, h)(copy(state), batch)
mesh = shd.make_mesh((2, 2), ("data", "model"))
pol = shd.ShardingPolicy(mesh)
placed = steps.place_state(copy(state), cfg, pol)
new, m2 = steps.build_train_step(cfg, h, pol)(placed, batch)
np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                           rtol=1e-4)
assert calls["all_gather_into_tensor"] > 0
assert calls["reduce_scatter_tensor"] > 0
specs = steps._spec_leaves(steps.param_specs(cfg, pol))
for a, b in ((one["params"], new["params"]),
             (one["opt"]["mu"], new["opt"]["mu"]),
             (one["opt"]["nu"], new["opt"]["nu"])):
    for (k, x), y, spec in zip(tree_items(a), steps._leaves(b), specs):
        assert isinstance(y, DTensor)
        assert y.to_local().shape == shd.local_shard(x, spec, mesh).shape
        np.testing.assert_allclose(y.full_tensor().numpy(), x.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=str(k))
print("BLOCK_OK", dict(calls))
""", 4)
    assert all(o.startswith("BLOCK_OK") for o in outs)


def test_tensor_parallel_step_matches_one_rank():
    """A (1, 2) mesh splits heads and MLP units over "model": qwen3 (its
    one kv head on both ranks) with remat "dots" and 2 microbatches,
    gemma3 (kv heads split, local windows), deepseek-moe (experts split),
    jamba (experts and mamba heads split), mamba2 (mamba heads split) and
    the VLM (self and cross attention and MLPs split), the vocab split
    too; each rank's attention kernel sees its 2 of 4 heads and its
    ``ssd_scan`` its 4 of 8 mamba heads, and the loss and grad norm are
    one rank's.  A qwen3 of 3 heads, which the axis does not divide, runs
    its attention whole (the kernel sees 3 heads) and its MLPs split (every
    MLP call on ``d_ff``/2 hidden units) in training, prefill and decode:
    loss and grad norm as above, the prefill's logits and the cache within
    1e-5 of their largest values, the decode's tokens equal."""
    outs = run_ranks(_MODEL + SEEN + """
from repro_torch.distributed import tensor_parallel
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
heads, units = [], []
kernel, mlp = fa.flash_attention, L.mlp
fa.flash_attention = lambda q, *a, **k: heads.append(q.shape[2]) or \
    kernel(q, *a, **k)
L.mlp = lambda p, *a, **k: units.append(p["wi"].shape[-1]) or mlp(p, *a, **k)
mesh = shd.make_mesh((1, 2), ("data", "model"))
pol = shd.ShardingPolicy(mesh)
cases = [("qwen3-8b", dict(remat="dots", accum=2), {}),
         ("gemma3-4b", {}, {}), ("deepseek-moe-16b", {}, {}),
         ("jamba-v0.1-52b", {}, {}), ("mamba2-2.7b", {}, {}),
         ("llama-3.2-vision-90b", {}, {}),
         ("qwen3-8b", {}, {"n_heads": 3})]
for arch, kw, over in cases:
    c = dataclasses.replace(get_config(arch).reduced(),
                            compute_dtype="float32", **over)
    h = dataclasses.replace(hp, **kw)
    st = steps.init_state(c, 0, device="cpu")
    st["step"] = torch.tensor(1, dtype=torch.int32)
    b = zoo.make_inputs(c, 4, 3, seq=32, device="cpu")
    b["labels"] = batch["labels"] % c.vocab_size
    tp = tensor_parallel.plan(c, pol)
    attn = c.family != "ssm"
    split = attn and c.n_heads % 2 == 0
    assert (tp is not None and tp.attn
            and tp.cfg.n_heads == c.n_heads // 2) == split, arch
    assert (tp is not None and tp.ff == (48 * RANK, 48)) == attn, arch
    heads.clear()
    _, m1 = steps.build_train_step(c, h)(copy(st), b)
    assert set(heads) == ({c.n_heads} if attn else set()), (arch, heads)
    heads.clear()
    units.clear()
    with Seen(c, mesh.get_group("model")) as seen:
        _, m2 = steps.build_train_step(c, h, pol)(
            steps.place_state(copy(st), c, pol), b)
    assert set(heads) == ({c.n_heads // (2 if split else 1)} if attn
                          else set()), (arch, heads)
    if over:
        assert set(units) == {c.d_ff // 2}, units
    # ssd_scan runs on [rows x heads, chunks, p, n]: 4 rows, 4 of 8 heads
    assert seen.scans == ({4 * c.ssm_heads // 2} if c.ssm_state
                          else set()), (arch, seen.scans)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5, err_msg=arch)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4,
                               err_msg=arch)

# serving the 3-head qwen3 (c): its one kv head splits the cache's
# sequence, the attention runs whole and the MLPs split
params = tree_map(torch.clone, st["params"])
placed = steps.place(params, steps.param_specs(c, pol), mesh)
prompt = {"tokens": b["tokens"][:, :12]}
want_l, want_c = steps.build_prefill_step(c, hp)(params, prompt,
                                                 cache_len=16)
units.clear()
got_l, got_c = steps.build_prefill_step(c, hp, pol)(placed, prompt,
                                                    cache_len=16)
assert set(units) == {c.d_ff // 2}, units
layout = steps.CacheLayout(c, pol, want_c)
assert not layout.tp.attn and layout.tp.ff == (48 * RANK, 48)
scale = float(want_l.abs().max())
assert float((got_l - want_l).abs().max()) <= 1e-5 * scale
one, sharded = steps.build_serve_step(c, hp), steps.build_serve_step(c, hp,
                                                                      pol)
t1 = t2 = torch.argmax(want_l, -1).to(torch.int32)
for pos in range(12, 15):
    units.clear()
    t1, _ = one(params, want_c, t1, pos)
    t2, _ = sharded(placed, got_c, t2, pos)
    assert set(units) == {c.d_ff // 2, c.d_ff}, units
    assert torch.equal(t1, t2), (pos, t1, t2)
    for (k, x), (_, y) in zip(tree_items(want_c), tree_items(got_c)):
        err = float((y.full_tensor() - x).abs().max())
        assert err <= 1e-5 * float(x.abs().max()), (pos, k, err)
print("TP_OK")
""", 2)
    assert all(o.startswith("TP_OK") for o in outs)


# what a rank computes under a sharded step, seen op by op: ``vocab`` the
# ops whose result has a dim of the vocab's size (whole logits, a whole
# head or embedding); ``over_model`` the all-gathers over "model" whose
# result leads with the expert count or spans the vocab (an expert leaf,
# the head or the embedding gathered whole over "model"); ``experts`` the
# expert count of every expert ``bmm`` (its weight [E, D, F] or [E, F, D],
# D ``d_model`` / ``d_parts``: a block of it under a split of d_model);
# ``scans`` the rows times heads of every ``ssd_scan`` call
SEEN = """
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.distributed.tensor import DTensor


class Seen(TorchDispatchMode):
    def __init__(self, cfg, group, d_parts=1):
        super().__init__()
        self.cfg, self.group = cfg, group.group_name
        self.d_parts = d_parts
        self.vocab, self.over_model, self.experts = [], [], set()
        self.scans = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func._schema.name)
        V, E = self.cfg.vocab_size, self.cfg.n_experts
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor) \\
                    and V in t.shape:
                self.vocab.append((name, tuple(t.shape)))
        if name.endswith("all_gather_into_tensor") and args[2] == self.group \\
                and (out.shape[0] == E or V in out.shape):
            self.over_model.append(tuple(out.shape))
        D, F = self.cfg.d_model // self.d_parts, self.cfg.d_expert
        if name == "aten::bmm" and tuple(args[1].shape[1:]) in ((D, F),
                                                              (F, D)):
            self.experts.add(args[1].shape[0])
        if name == "repro_torch::ssd_scan":
            self.scans.add(args[0].shape[0])
        return out
"""


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", (2, 1)), ("deepseek-moe-16b", (2, 2)),
    ("jamba-v0.1-52b", (2, 1)), ("jamba-v0.1-52b", (2, 2))])
def test_moe_step_matches_one_rank(arch, shape):
    """Reduced MoE models (fp32, remat "dots", a vocab of 200 that no
    other dim shares; jamba's cross entropy in chunks of 64 columns) on
    ("data", "model") meshes whose data axis splits the rows: the loss
    within rtol 1e-5 and the grad norm within rtol 1e-4 of one rank's, the
    MoE aux loss being the whole batch's.  Where
    "model" has two ranks the vocab and the experts split over it: no rank
    makes a tensor as wide as the vocab, no all-gather over "model"
    carries an expert leaf, the head or the embedding, and the expert
    products run on the rank's 2 of 4 experts.  The mamba layers split
    their heads over "model": ``ssd_scan`` runs on the rank's 2 rows and
    its 8 / m of 8 heads; the (2, 2) jamba case also trains reduced
    mamba2 on the same ranks."""
    archs = [arch] + (["mamba2-2.7b"] if arch.startswith("jamba")
                      and shape == (2, 2) else [])
    outs = run_ranks(_MODEL + SEEN + f"""
mesh = shd.make_mesh({shape!r}, ("data", "model"))
pol = shd.ShardingPolicy(mesh)
m = mesh.shape["model"]
for arch in {archs!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32", vocab_size=200)
    h = dataclasses.replace(hp, remat="dots",
                            vocab_chunk=64 if "jamba" in cfg.name else 0)
    st = steps.init_state(cfg, 0, device="cpu")
    st["step"] = torch.tensor(1, dtype=torch.int32)
    b = zoo.make_inputs(cfg, 4, 3, seq=32, device="cpu")
    b["labels"] = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (4, 32)))
    _, m1 = steps.build_train_step(cfg, h)(copy(st), b)
    placed = steps.place_state(copy(st), cfg, pol)
    with Seen(cfg, mesh.get_group("model")) as seen:
        _, m2 = steps.build_train_step(cfg, h, pol)(placed, b)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5, err_msg=arch)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4,
                               err_msg=arch)
    if cfg.ssm_state:
        assert seen.scans == {{2 * cfg.ssm_heads // m}}, (arch, seen.scans)
    if m == 2:
        assert not seen.vocab, seen.vocab[:4]
        assert not seen.over_model, seen.over_model
        assert seen.experts == ({{cfg.n_experts // 2}} if cfg.n_experts
                                else set()), seen.experts
print("MOE_OK", float(m1["loss"]), float(m2["loss"]))
""", shape[0] * shape[1])
    assert all(o.startswith("MOE_OK") for o in outs)


def test_sharded_train_loop_checkpoints_and_resumes(tmp_path):
    """``train_loop`` on 4 ranks builds the reference's (2, 2) mesh, keeps
    the state at ``state_specs``, writes its checkpoints from rank 0 and
    resumes onto the mesh; its losses are one process's (phi3 reduced in
    fp32, as ``test_torch_trainer.py``'s replay in its compute dtype)."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.optim import adam
    hp = steps.HParams(remat="none", optimizer=adam.AdamWConfig(
        lr=1e-3, total_steps=4, warmup_steps=2))
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                              compute_dtype="float32")
    _, want = train.train_loop(cfg, ShapeConfig("t", "train", 32, 4), hp,
                               steps=4, log_every=0, device="cpu")
    outs = run_ranks(f"""
from torch.distributed.tensor import DTensor
import dataclasses
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps, train
from repro_torch.optim import adam
hp = steps.HParams(remat="none", optimizer=adam.AdamWConfig(
    lr=1e-3, total_steps=4, warmup_steps=2))
cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                          compute_dtype="float32")
shape = ShapeConfig("t", "train", 32, 4)
mesh = train.make_mesh_if_possible(device="cpu")
assert mesh.shape == {{"data": 2, "model": 2}}, mesh
d = {str(tmp_path / "ck")!r}
state, a = train.train_loop(cfg, shape, hp, steps=2, ckpt_dir=d,
                            ckpt_every=2, log_every=0, resume=False,
                            device="cpu")
assert isinstance(state["params"]["embed"], DTensor)
dist.barrier()
state, b = train.train_loop(cfg, shape, hp, steps=4, ckpt_dir=d,
                            ckpt_every=100, log_every=0, device="cpu")
print("LOOP", *(a + b))
""", 4)
    assert os.path.isdir(tmp_path / "ck" / "step_2")
    for out in outs:
        got = [float(v) for v in out.split()[1:]]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_cli_on_two_ranks(tmp_path):
    """``python -m repro_torch.launch.train`` started once a rank with
    ``--world-size 2 --rank r --pg-store``: both ranks train on the (1, 2)
    mesh and rank 0 writes the checkpoint."""
    import subprocess
    import sys

    from test_torch_sharding import SRC
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-8b", "--steps", "2", "--batch", "2", "--seq", "16",
           "--device", "cpu", "--world-size", "2", "--pg-store",
           str(tmp_path / "store"), "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    assert C.latest_step(str(tmp_path / "ck")) == 2


def test_compressed_psum_four_ranks():
    """int8 all-reduce over a ("data",) axis of 4 ranks: within
    4·scale + 1e-5 of the exact sum (``tests/test_compression.py``)."""
    outs = run_ranks("""
import numpy as np
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import compressed_psum
mesh = shd.make_mesh((4,), ("data",))
x = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (4, 128)).astype(np.float32))
got = compressed_psum(x[RANK], "data", mesh)
err = float((got - x.sum(0)).abs().max())
scale = float(x.abs().max()) / 127
assert err <= 4 * scale + 1e-5, (err, scale)
assert got.dtype == torch.float32 and got.shape == (128,)
print("PSUM_OK", err)
""", 4)
    errs = {o.split()[1] for o in outs}
    assert len(errs) == 1          # every rank holds the same sum


def test_elastic_restore_across_meshes(tmp_path):
    """A checkpoint written by one process (no mesh) restores onto a 2 x 2
    and a 4 x 1 mesh with equal values, each rank holding its blocks at
    ``state_specs``, laid out as DTensor lays them out; a sharded state
    saved from the 2 x 2 mesh restores equal on one process."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    state = steps.init_state(cfg, 0, device="cpu")
    state["step"] = torch.tensor(2, dtype=torch.int32)
    C.save(state, str(tmp_path / "elastic"), step=2)
    run_ranks(f"""
import numpy as np
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.checkpoint import ckpt as C
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps

cfg = get_config("phi3-mini-3.8b").reduced()
template = steps.init_state(cfg, 1, device="cpu")
saved, _ = C.restore(template, {str(tmp_path / 'elastic')!r})
for shape in [(2, 2), (4, 1)]:
    mesh = shd.make_mesh(shape, ("data", "model"))
    pol = shd.ShardingPolicy(mesh)
    sh = steps._to_shardings(mesh, steps.state_specs(cfg, pol))
    got, step = C.restore(template, {str(tmp_path / 'elastic')!r},
                          shardings=sh)
    assert step == 2
    n_split = 0
    for (k, a), (_, b) in zip(tree_items(saved),
                              tree_items(got)):
        assert isinstance(b, DTensor), k
        np.testing.assert_array_equal(b.full_tensor().numpy(), a)
        ref = distribute_tensor(torch.from_numpy(np.asarray(a)),
                                mesh.device_mesh, b.placements)
        assert torch.equal(ref.to_local(), b.to_local()), k
        n_split += b.to_local().numel() < a.size
    assert n_split > 0
    if shape == (2, 2):
        C.save(got, {str(tmp_path / 'resaved')!r}, step=3)
print("ELASTIC_OK")
""", 4)
    again, step = C.restore(state, str(tmp_path / "resaved"))
    assert step == 3
    for (k, a), (_, b) in zip(C.tree_items(state), C.tree_items(again)):
        np.testing.assert_array_equal(b, a.numpy())
