"""The port's tracer beyond the SIREN gradient: the ops a filter bank's
heads and other MLPs bring (``cat``, ``slice``, ``relu``, the fused
``tanh`` / ``sigmoid`` backward ops), against the reference.

The same MLP weights, made with numpy from a seed, go through the
reference's ``compile_gradient`` and the port's (on the CPU, where every
kernel wrapper runs its plain version); a ReLU MLP's gradient raises in
both packages, since the reference's compiler cannot compile it either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.config import HardwareConfig
from repro_torch.core.trace import extract_graph
from test_torch_pipeline import _close_scaled


@pytest.fixture(autouse=True)
def fresh_cache():
    jpipeline.clear_compile_cache()
    tpipeline.clear_compile_cache()
    yield


def _ops(g):
    return [n.op for n in g.nodes.values()]


def test_cat_slice_relu_lower_to_concat_slice_maximum():
    x = torch.zeros(8, 3)

    def fn(z):
        cat = torch.cat([z, 2 * z], -1)                  # [8, 6]
        return torch.relu(cat[:, 1:4])

    g = extract_graph(fn, x)
    by_op = {n.op: n for n in g.nodes.values()}
    assert {"Concat", "Slice", "Maximum"} <= set(by_op)
    cat = by_op["Concat"]
    assert cat.shape == (8, 6) and dict(cat.params)["dimension"] == 1
    sl = dict(by_op["Slice"].params)
    assert sl["start_indices"] == (0, 1)
    assert sl["limit_indices"] == (8, 4)
    assert sl["strides"] == (1, 1)
    mx = by_op["Maximum"]
    zero = g.nodes[mx.inputs[1]]
    assert zero.op == "Const" and zero.shape == () and float(zero.const) == 0


def test_whole_axis_slice_and_same_shape_view_make_no_node():
    """``feats[:, :C]`` slices axis 0 over all of it (end = sys.maxsize);
    that slice, and a reshape to the same shape, map to their operand."""
    g = extract_graph(lambda z: z[:, :2].reshape(8, -1) * 3, torch.zeros(8, 5))
    ops = _ops(g)
    assert ops.count("Slice") == 1 and "Reshape" not in ops
    sl = dict(next(n for n in g.nodes.values() if n.op == "Slice").params)
    assert sl["limit_indices"] == (8, 2)


def test_slice_with_step_and_negative_bounds():
    x = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    fn = lambda z: z[:, -7:-1:2] + 1                     # noqa: E731
    g = extract_graph(fn, x)
    sl = dict(next(n for n in g.nodes.values() if n.op == "Slice").params)
    assert sl == {"start_indices": (0, 3), "limit_indices": (4, 9),
                  "strides": (1, 2)}
    from repro_torch.core.executor import reference_executor
    (got,) = reference_executor(g)(x)
    assert torch.equal(got, fn(x))


@pytest.mark.parametrize("name", ["tanh_backward", "sigmoid_backward"])
def test_fused_backward_decomposes(name):
    """tanh_backward / sigmoid_backward become elementwise IR ops whose
    values equal torch's own fused op."""
    from repro_torch.core.executor import reference_executor
    act = torch.tanh if name == "tanh_backward" else torch.sigmoid
    x = torch.linspace(-2, 2, 24).reshape(8, 3)
    seed = torch.linspace(0.5, 1.5, 24).reshape(8, 3)

    def fn(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            return torch.autograd.grad(act(z), z, seed)[0]

    g = extract_graph(fn, x)
    assert not {"tanh_backward", "sigmoid_backward"} & set(_ops(g))
    (got,) = reference_executor(g)(x)
    torch.testing.assert_close(got, fn(x), rtol=1e-6, atol=1e-7)


def _mlp(seed=0, hidden=16):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(2, hidden)).astype(np.float32)
    b1 = rng.normal(size=hidden).astype(np.float32)
    w2 = (rng.normal(size=(hidden, 1)) / np.sqrt(hidden)).astype(np.float32)
    b2 = rng.normal(size=1).astype(np.float32)
    coords = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    return (w1, b1, w2, b2), coords


def _pair(act_name):
    """(reference fn, port fn) of one MLP with the given activation."""
    (w1, b1, w2, b2), coords = _mlp()
    jact = {"tanh": jnp.tanh, "sigmoid": jax.nn.sigmoid,
            "relu": jax.nn.relu}[act_name]
    tact = {"tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "relu": torch.relu}[act_name]
    jw = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    tw = [torch.from_numpy(a) for a in (w1, b1, w2, b2)]

    def jf(x):
        return jact(x @ jw[0] + jw[1]) @ jw[2] + jw[3]

    def tf(x):
        return tact(x @ tw[0] + tw[1]) @ tw[2] + tw[3]
    return jf, tf, coords


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("fuse", [True, False])
def test_mlp_gradient_matches_reference(act, order, fuse):
    jf, tf, coords = _pair(act)
    ref = jpipeline.compile_gradient(jf, order, jnp.asarray(coords[:64]))
    cg = tpipeline.compile_gradient(
        tf, order, torch.from_numpy(coords[:64]),
        config=HardwareConfig(use_pallas=True, fuse_regions=fuse),
        device="cpu")
    want = ref.apply_batched(jnp.asarray(coords))
    got = cg.apply_batched(torch.from_numpy(coords))
    assert len(got) == len(want) == 2 ** order
    for a, b in zip(got, want):
        _close_scaled(a, b)


@pytest.mark.parametrize("order", [1, 2])
def test_relu_gradient_raises_in_both_packages(order):
    jf, tf, coords = _pair("relu")
    with pytest.raises(NotImplementedError, match="Gt"):
        jpipeline.compile_gradient(jf, order, jnp.asarray(coords[:64]))
    with pytest.raises(NotImplementedError, match="codegen: Gt"):
        tpipeline.compile_gradient(tf, order, torch.from_numpy(coords[:64]),
                                   device="cpu")
