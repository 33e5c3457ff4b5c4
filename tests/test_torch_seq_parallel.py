"""Sequence parallelism (``seq_parallel``) on four gloo ranks: a 2 x 2
("data", "model") mesh whose batch, placed at ``seq_parallel``'s
``batch_specs``, splits its rows over "data" and its sequence over
"model".  Each rank runs the residual stream of its 2 rows and 16 of 32
positions, and the layers gather the sequence where they need it
(``distributed/tensor_parallel.SeqParallel``).

The families and splits beside reduced qwen3 (whose case runs in
``test_torch_sharded_train.py::test_sharded_train_step_matches_one_rank``):
deepseek-moe (experts and shared experts split, the aux loss over the
whole batch), jamba (mamba heads, experts, the attention of its one kv head
and its dense MLPs split), mamba2 (mamba layers alone), the VLM (self and
cross layers split), a dense config whose 3 heads and vocab of 127 the
axis does not divide (attention and head whole, MLPs split), and a jamba
whose attention, 3 experts, 3 mamba heads, MLP units and vocab all run
whole on every rank.  Each is held to one rank (``SP_CASE``): the train
step's loss, grad norm, updated parameters and moments and the prefill's
logits and cache, with every norm on the rank's block and every attention
or ``ssd_scan`` call on the whole sequence.
"""

import pytest

from test_torch_sharded_train import _MODEL, SP_CASE
from test_torch_sharding import run_ranks

# case -> (arch, overrides of its reduced config, HParams overrides)
_CASES = {
    "moe": ("deepseek-moe-16b", {}, {"remat": "dots"}),
    "hybrid": ("jamba-v0.1-52b", {}, {"remat": "dots", "vocab_chunk": 64}),
    "ssm": ("mamba2-2.7b", {}, {"remat": "full"}),
    "vlm": ("llama-3.2-vision-90b", {}, {}),
    "heads": ("qwen3-8b", {"n_heads": 3, "vocab_size": 127},
              {"remat": "dots", "accum": 2}),
    "whole": ("jamba-v0.1-52b", {"n_heads": 3, "n_experts": 3,
                                 "vocab_size": 127, "d_model": 48,
                                 "ssm_head_dim": 32, "d_ff": 99}, {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_seq_parallel_matches_one_rank(case):
    arch, over, kw = _CASES[case]
    outs = run_ranks(_MODEL + SP_CASE + f"""
from repro_torch.distributed import tensor_parallel
c = dataclasses.replace(get_config({arch!r}).reduced(),
                        compute_dtype="float32", **{over!r})
h = dataclasses.replace(hp, **{kw!r})
st = steps.init_state(c, 0, device="cpu")
st["step"] = torch.tensor(1, dtype=torch.int32)
b = zoo.make_inputs(c, 4, 3, seq=32, device="cpu")
b["labels"] = batch["labels"] % c.vocab_size
one, m1 = steps.build_train_step(c, h)(copy(st), b)
mesh = shd.make_mesh((2, 2), ("data", "model"))
tp = tensor_parallel.plan(c, shd.ShardingPolicy(mesh))
split = tensor_parallel.model_split(mesh, steps.layer_specs(
    c, shd.ShardingPolicy(mesh)))
if {case!r} in ("heads", "whole"):
    # the heads the axis does not divide run whole
    assert tp is None or not tp.attn, tp
    assert split is None or split.vocab is None, split
if {case!r} == "whole":
    assert tp is None and split is None, (tp, split)
loss = sp_case(c, h, st, b, mesh, one, m1)
print("SP_OK", float(m1["loss"]), loss)
""", 4, timeout=240)
    assert all(o.startswith("SP_OK") for o in outs)
