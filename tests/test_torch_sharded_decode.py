"""Sharded prefill and decode that keep the cache at ``cache_specs`` on
four gloo ranks (a 2 x 2 ("data", "model") mesh, and for three cases a
4 x 1 one, where every row and every parameter block splits over
"data"): each rank holds and writes its blocks of the cache alone, and
the decode step is weight-stationary: it multiplies with the parameter
blocks it holds and moves only activations.

Two layouts: the kv heads split over "model" (reduced gemma3: two kv
heads, local windows) and the sequence split over it (reduced qwen3: one
kv head, a window of 8 in its first layer, so that a rank's whole block
falls outside the window).  The other families run through both: reduced
jamba (its mamba heads split over "model", each rank's SSM state block
its heads', the conv rows gathered a layer at a time and their blocks
written back; MoE layers; its one kv head splits the sequence), reduced
mamba2 (the mamba layers alone, no kv cache: "states"), the reduced VLM with two kv heads (self and cross layers split
by heads) and with its one (the cached patch keys and values split by
sequence, merged over "model"), reduced deepseek-moe (MoE layers under the
attention-only head split), reduced dbrx (MoE layers under the sequence
split) and reduced musicgen (an embedding prompt).  Their vocab of 128 and
4 experts split over "model": every rank computes its columns of the
logits and runs its 2 experts.

Every rank builds the parameters and the prompt from the same seeds, runs
the unsharded steps itself and holds the sharded ones to them: greedy
tokens ``torch.equal``, the prefill's last logits within 1e-5 of
max|logits|, each rank's cache block within 1e-5 of max|cache| of the
matching block of the unsharded cache after the prefill and after each
decode step, no cache leaf larger than its block, no collective of a
decode step reading or writing an attention cache block, an SSM state
block or a parameter block (the storage of a block, or of a copy of one:
a clone, cast or concatenation of a block, spied op by op).
"""

import pytest

from test_torch_sharded_train import SEEN
from test_torch_sharding import run_ranks

# case -> (arch, overrides of its reduced config, how the kv cache splits
# over "model")
_CASES = {
    "heads": ("gemma3-4b", {}, "heads"),
    "sequence": ("qwen3-8b", {"sliding_window": 8, "global_every": 2},
                 "sequence"),
    "hybrid": ("jamba-v0.1-52b", {}, "sequence"),
    "vlm-heads": ("llama-3.2-vision-90b", {"n_kv_heads": 2}, "heads"),
    "vlm-sequence": ("llama-3.2-vision-90b", {}, "sequence"),
    "moe-heads": ("deepseek-moe-16b", {}, "heads"),
    "moe-sequence": ("dbrx-132b", {}, "sequence"),
    "embeds": ("musicgen-medium", {}, "heads"),
    "ssm": ("mamba2-2.7b", {}, "states"),
}


# the 4 x 1 mesh's cases: a "model" axis of one rank splits the kv heads
# trivially, so the attention layout reads "heads"
_FOUR_BY_ONE = {"sequence": "heads", "moe-heads": "heads",
                "hybrid": "heads"}


@pytest.mark.parametrize("case,mesh", [
    pytest.param(c, (2, 2), id=c) for c in sorted(_CASES)] + [
    pytest.param(c, (4, 1), id=f"{c}-4x1") for c in sorted(_FOUR_BY_ONE)])
def test_prefill_then_decode_hold_cache_blocks(case, mesh):
    arch, over, layout = _CASES[case]
    if mesh == (4, 1):
        layout = _FOUR_BY_ONE[case]
    outs = run_ranks(f"""
import dataclasses
import weakref
import numpy as np
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import zoo

cfg = dataclasses.replace(get_config({arch!r}).reduced(),
                          compute_dtype="float32", **{over!r})
hp = steps.HParams(attn_impl="flash")
params = steps.init_state(cfg, 0, device="cpu")["params"]
prompt = {{k: v for k, v in zoo.make_inputs(cfg, 4, 3, seq=12,
                                           device="cpu").items()
          if k != "labels"}}
mesh = shd.make_mesh({mesh!r}, ("data", "model"))
pol = shd.ShardingPolicy(mesh)
placed = steps.place(params, steps.param_specs(cfg, pol), mesh)
# ops whose result holds the values of their operands as they are
COPIES = {{"clone", "_to_copy", "copy_", "cat", "stack", "contiguous",
          "view_copy", "slice_copy", "expand_copy"}}


class Moved(TorchDispatchMode):
    # the storages every collective reads or writes, and the collectives
    # that carry a parameter block: one that reads or writes the storage
    # of a block or of a copy of one (``params``: the blocks, and every
    # live tensor a copy made of one)
    def __init__(self, blocks):
        super().__init__()
        self.storages = set()
        self.blocks, self.params = list(blocks), weakref.WeakSet()
        self.carried = []

    def held(self):
        return {{t.untyped_storage().data_ptr()
                for t in self.blocks + list(self.params)}} - {{0}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if func.namespace in ("c10d", "_c10d_functional"):
            held = self.held()
            for t in ins:
                self.storages.add(t.untyped_storage().data_ptr())
                if t.untyped_storage().data_ptr() in held:
                    self.carried.append((str(func), tuple(t.shape)))
        out = func(*args, **(kwargs or {{}}))
        name = func._schema.name.split("::")[-1]
        if name in COPIES:
            held = self.held()
            if any(t.untyped_storage().data_ptr() in held for t in ins):
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self.params.add(t)
        return out


want_l, want_c = steps.build_prefill_step(cfg, hp)(params, prompt,
                                                   cache_len=16)
got_l, got_c = steps.build_prefill_step(cfg, hp, pol)(placed, prompt,
                                                      cache_len=16)
scale = float(want_l.abs().max())
assert float((got_l - want_l).abs().max()) <= 1e-5 * scale, \
    float((got_l - want_l).abs().max()) / scale
specs = steps._spec_leaves(steps.cache_specs(cfg, pol, want_c))
layout = steps.CacheLayout(cfg, pol, want_c)
split = "heads" if layout.tp is not None and layout.tp.attn else \
    "sequence" if "k" in layout.shapes else "states"
assert split == {layout!r}, split


def check(when):
    for (k, w), (_, g), spec in zip(tree_items(want_c), tree_items(got_c),
                                    specs):
        want = shd.local_shard(w, spec, mesh)
        assert isinstance(g, DTensor) and g.shape == w.shape, k
        block = g.to_local()
        assert block.shape == want.shape and block.numel() * 4 == w.numel(), \\
            (k, block.shape, w.shape)
        err = float((block - want).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (when, k, err)


check("prefill")
# the attention caches and, split by heads, the SSM states
blocks = {{g.to_local().untyped_storage().data_ptr()
          for k, g in tree_items(got_c) if k[-1] in zoo.KV_KEYS + ("ssm",)}}
assert layout.heads == (bool(cfg.ssm_state) and mesh.shape["model"] > 1), \
    layout.heads
one = steps.build_serve_step(cfg, hp)
sharded = steps.build_serve_step(cfg, hp, pol)
t1 = t2 = torch.argmax(want_l, -1).to(torch.int32)
for pos in range(12, 16):
    t1, _ = one(params, want_c, t1, pos)
    with Moved([t.to_local() for _, t in tree_items(placed)]) as moved:
        t2, _ = sharded(placed, got_c, t2, pos)
    assert torch.equal(t1, t2), (pos, t1, t2)
    assert moved.storages and blocks and not moved.storages & blocks, pos
    assert not moved.carried, (pos, moved.carried[:4])
    check(pos)
print("DECODE_OK", split)
""", 4)
    assert all(o.split() == ["DECODE_OK", layout] for o in outs)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_moe_serving_keeps_model_blocks(arch):
    """Sharded prefill and three decode steps of reduced MoE models (fp32,
    a vocab of 200 that no other dim shares) on the 2 x 2 mesh, their
    vocab and experts split over "model": the one-rank logits (within
    1e-5 of max|logits|) and tokens (``torch.equal``); no rank makes a
    tensor as wide as the vocab but the last logits gathered whole (the
    rank's rows, then every row) in the prefill, none in decode; no
    all-gather over "model" carries an expert leaf, the head or the
    embedding; the expert products run on the rank's 2 of 4 experts."""
    outs = run_ranks(SEEN + f"""
import dataclasses
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import zoo

cfg = dataclasses.replace(get_config({arch!r}).reduced(),
                          compute_dtype="float32", vocab_size=200)
hp = steps.HParams(attn_impl="flash")
params = steps.init_state(cfg, 0, device="cpu")["params"]
prompt = {{"tokens": zoo.make_inputs(cfg, 4, 3, seq=12,
                                    device="cpu")["tokens"]}}
mesh = shd.make_mesh((2, 2), ("data", "model"))
pol = shd.ShardingPolicy(mesh)
placed = steps.place(params, steps.param_specs(cfg, pol), mesh)
want_l, want_c = steps.build_prefill_step(cfg, hp)(params, prompt,
                                                   cache_len=16)
with Seen(cfg, mesh.get_group("model")) as pre:
    got_l, got_c = steps.build_prefill_step(cfg, hp, pol)(placed, prompt,
                                                          cache_len=16)
scale = float(want_l.abs().max())
assert float((got_l - want_l).abs().max()) <= 1e-5 * scale
assert {{s for _, s in pre.vocab}} <= {{(2, 200), (4, 200)}}, pre.vocab
one = steps.build_serve_step(cfg, hp)
sharded = steps.build_serve_step(cfg, hp, pol)
t1 = t2 = torch.argmax(want_l, -1).to(torch.int32)
# decode multiplies with the rank's blocks: its experts over "model",
# their half of d_model over "data"
dec = Seen(cfg, mesh.get_group("model"), d_parts=2)
for pos in range(12, 15):
    t1, _ = one(params, want_c, t1, pos)
    with dec:
        t2, _ = sharded(placed, got_c, t2, pos)
    assert torch.equal(t1, t2), (pos, t1, t2)
assert not dec.vocab, dec.vocab
for seen in (pre, dec):
    assert not seen.over_model, seen.over_model
    assert seen.experts == {{2}}, seen.experts
print("MOE_SERVE_OK")
""", 4)
    assert all(o.startswith("MOE_SERVE_OK") for o in outs)


def test_multi_pod_decode_matches_one_rank():
    """The weight-stationary decode over the multi-pod axes ("pod",
    "data", "model") = (2, 2, 2) on eight gloo ranks: ``d_model`` and the
    rows split over ("pod", "data") together (their partial sums
    reduce-scattered over "pod", then "data"), for reduced jamba (mamba,
    attention split by sequence, MoE) and deepseek-moe (heads split):
    greedy tokens ``torch.equal`` to the unsharded step's and each rank's
    cache blocks within 1e-5 of max|cache| after four steps."""
    outs = run_ranks("""
import dataclasses
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import zoo

mesh = shd.make_mesh((2, 2, 2), ("pod", "data", "model"))
pol = shd.ShardingPolicy(mesh)
for arch in ("jamba-v0.1-52b", "deepseek-moe-16b"):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    hp = steps.HParams(attn_impl="flash")
    params = steps.init_state(cfg, 0, device="cpu")["params"]
    prompt = {"tokens": zoo.make_inputs(cfg, 4, 3, seq=12,
                                        device="cpu")["tokens"]}
    placed = steps.place(params, steps.param_specs(cfg, pol), mesh)
    want_l, want_c = steps.build_prefill_step(cfg, hp)(params, prompt,
                                                       cache_len=16)
    got_l, got_c = steps.build_prefill_step(cfg, hp, pol)(placed, prompt,
                                                          cache_len=16)
    ws = steps.CacheLayout(cfg, pol, want_c).stationary
    assert ws.sum == ws.rows == ("pod", "data"), (ws.sum, ws.rows)
    one = steps.build_serve_step(cfg, hp)
    sharded = steps.build_serve_step(cfg, hp, pol)
    t1 = t2 = torch.argmax(want_l, -1).to(torch.int32)
    for pos in range(12, 16):
        t1, _ = one(params, want_c, t1, pos)
        t2, _ = sharded(placed, got_c, t2, pos)
        assert torch.equal(t1, t2), (arch, pos, t1, t2)
    specs = steps._spec_leaves(steps.cache_specs(cfg, pol, want_c))
    for (k, w), (_, g), spec in zip(tree_items(want_c), tree_items(got_c),
                                    specs):
        err = float((g.to_local() - shd.local_shard(w, spec, mesh)).abs()
                    .max())
        assert err <= 1e-5 * float(w.abs().max()), (arch, k, err)
print("POD_OK")
""", 8)
    assert all(o.startswith("POD_OK") for o in outs)
