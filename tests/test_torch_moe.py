"""The port's ``moe_ffn`` against the reference's.

The reference dispatches and combines through one-hot einsums; the port
moves rows by index.  Both must route the same tokens to the same expert
slots and drop the same ones: on the same parameters (the reference's
``init_params``) and the same numpy inputs, the output and the aux loss
are held within 1e-5 of max|reference| in fp32; in bf16 the selection is
exact, but float32 accumulations that differ in the last bit can round
the expert activations apart, so the output's error against a float64
evaluation (bf16-rounded inputs and weights) may be at most twice the
reference's, and the aux loss is held within 1e-5.
Cases: dropping (a small ``capacity_factor``), several groups (a small
``group_tokens``), decode size (T = B), shared experts on and off, and
tied gates (``lax.top_k`` takes the lower index first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro.models.template import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers


def _setup(arch, dtype, shared=True, seed=0):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               compute_dtype=dtype)
    if not shared:
        jcfg = dataclasses.replace(jcfg, n_shared_experts=0)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype=dtype,
                               n_shared_experts=jcfg.n_shared_experts)
    jp = jinit_params(jzoo.moe_template(jcfg), jax.random.PRNGKey(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _run(jcfg, tcfg, jp, tp, x, **kw):
    dtype = jcfg.compute_dtype
    want, jaux = jlayers.moe_ffn(jcfg, jp, jnp.asarray(x, dtype), **kw)
    got, taux = tlayers.moe_ffn(
        tcfg, tp, torch.from_numpy(x).to(getattr(torch, dtype)), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    return (np.asarray(want, np.float64), float(jaux),
            got.double().numpy(), float(taux))


def _scaled(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


CASES = {
    # name: (B, S, kwargs)
    "default": (2, 16, {}),
    "dropping": (2, 16, {"capacity_factor": 0.5}),
    "groups": (2, 16, {"group_tokens": 8}),
    "groups_dropping": (4, 12, {"group_tokens": 16, "capacity_factor": 0.7}),
    "decode": (2, 1, {}),
    # 10 tokens in groups of 4 make 2 groups of 5
    "uneven_groups": (2, 5, {"group_tokens": 4}),
}


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, case, shared):
    B, S, kw = CASES[case]
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b", dtype, shared)
    x = np.random.default_rng(1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    want, jaux, got, taux = _run(jcfg, tcfg, jp, tp, x, **kw)
    assert abs(taux - jaux) <= 1e-5 * abs(jaux)
    if dtype == "float32":
        assert _scaled(got, want) <= 1e-5
        return
    bf = lambda t: t.to(torch.bfloat16).double()
    exact, _ = tlayers.moe_ffn(
        dataclasses.replace(tcfg, compute_dtype="float64"),
        jax.tree.map(bf, tp), bf(torch.from_numpy(x)), **kw)
    exact = exact.numpy()
    assert 0 < _scaled(got, exact) <= 2 * _scaled(want, exact)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_moe_ffn_other_archs(arch):
    jcfg, tcfg, jp, tp = _setup(arch, "float32", seed=2)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    want, jaux, got, taux = _run(jcfg, tcfg, jp, tp, x, capacity_factor=0.8)
    assert _scaled(got, want) <= 1e-5
    assert abs(taux - jaux) <= 1e-5 * abs(jaux)


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5])
def test_the_same_tokens_are_dropped(capacity_factor):
    """Without shared experts a token whose every slot was dropped comes out
    as zeros: the port's zero rows are the reference's, and there are
    some."""
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b", "float32", shared=False)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    want, _, got, _ = _run(jcfg, tcfg, jp, tp, x,
                           capacity_factor=capacity_factor)
    dropped = ~np.abs(want).any(-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(~np.abs(got).any(-1), dropped)
    assert _scaled(got, want) <= 1e-5


def test_tied_gates_take_the_lower_index():
    """A zero router ties every gate: top-k must pick experts 0..K-1 for
    every token, so the queues of the first K experts overflow and the
    rest stay empty, exactly as in the reference."""
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b", "float32", shared=False)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(4).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    want, jaux, got, taux = _run(jcfg, tcfg, jp, tp, x)
    assert _scaled(got, want) <= 1e-5 and taux == pytest.approx(jaux)
    assert (~np.abs(want).any(-1)).any()
    _, top_i = tlayers._top_k(torch.zeros((3, 4)), 2)
    assert top_i.tolist() == [[0, 1]] * 3


def test_ragged_group_fails_as_the_reference_does():
    """T not ``T // min(group_tokens, T)`` equal groups: both packages
    raise."""
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b", "float32")
    x = np.zeros((2, 5, tcfg.d_model), np.float32)      # 10 = 3 x 3 + 1
    with pytest.raises(TypeError):
        jlayers.moe_ffn(jcfg, jp, jnp.asarray(x), group_tokens=3)
    with pytest.raises(ValueError, match="groups"):
        tlayers.moe_ffn(tcfg, tp, torch.from_numpy(x), group_tokens=3)
