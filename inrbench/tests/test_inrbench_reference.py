"""The float64 references against torch.func derivatives at tiny sizes."""

from __future__ import annotations

import torch

from inrbench.reference import fit as ref_fit
from inrbench.reference import insp, siren

W0 = 30.0


def _params(sizes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return siren.as_dtype(siren.init(sizes, W0, g, "cpu"), torch.float64)


def _f(params):
    def f(x):                      # one coordinate [D] -> [C]
        h = x
        for i, layer in enumerate(params):
            h = h @ layer["w"] + layer["b"]
            if i < len(params) - 1:
                h = torch.sin(W0 * h)
        return h
    return f


def _func_outputs(params, x, order):
    """The program's layout from vmapped jacrev."""
    f = _f(params)
    fns = [f]
    for _ in range(order):
        fns.append(torch.func.jacrev(fns[-1]))
    d = [torch.func.vmap(fn)(x) for fn in fns]    # [N, C, D, D, ...]
    N, C = d[0].shape
    outs = [d[0]]
    for k in range(1, order + 1):
        t = d[k].reshape(N, C, -1, x.shape[1])     # rows over index paths
        outs += [t[:, c, r] for c in range(C) for r in range(t.shape[2])]
    return outs


def test_outputs_match_torch_func_orders_1_to_3():
    p = _params([2, 16, 16, 2], seed=1)
    x = torch.rand(9, 2, dtype=torch.float64) * 2 - 1
    for order in (1, 2, 3):
        got = siren.outputs(p, x, order, W0)
        want = _func_outputs(p, x, order)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-8)


def test_laplacian_is_the_hessian_trace():
    p = _params([2, 8, 8, 1], seed=2)
    x = torch.rand(5, 2, dtype=torch.float64)
    h = torch.func.vmap(torch.func.hessian(_f(p)))(x)     # [N, 1, 2, 2]
    torch.testing.assert_close(siren.laplacian(p, x, W0),
                               h.diagonal(dim1=-2, dim2=-1).sum(-1))


def test_bank_heads_read_the_feature_layout():
    p = _params([2, 8, 8, 1], seed=3)
    g = torch.Generator().manual_seed(4)
    heads = [siren.as_dtype(psi, torch.float64)
             for psi in insp.init([7, 5, 1], 2, g, "cpu")]
    x = torch.rand(6, 2, dtype=torch.float64)
    feats = torch.cat([o.reshape(6, -1) for o in _func_outputs(p, x, 2)],
                      -1)
    for psi, got in zip(heads, insp.outputs(p, heads, x, 2, W0)):
        h = torch.relu(feats @ psi[0]["w"] + psi[0]["b"])
        torch.testing.assert_close(got, h @ psi[1]["w"] + psi[1]["b"])


def test_fit_gradient_matches_torch_func():
    p = _params([2, 8, 8, 1], seed=5)
    x = torch.rand(40, 2, dtype=torch.float64)
    t = torch.rand(40, 1, dtype=torch.float64)
    loss, grads = ref_fit.loss_and_grads(p, x, t, W0, block=16)
    leaves = ref_fit.flat(p)

    def loss_of(*lv):
        f = _f(ref_fit.unflat(list(lv)))
        h = torch.func.vmap(torch.func.hessian(f))(x)
        lap = h.diagonal(dim1=-2, dim2=-1).sum(-1)
        return torch.mean(torch.sum((lap - t) ** 2, -1))

    want = torch.func.grad(loss_of, argnums=tuple(range(len(leaves))))(
        *leaves)
    torch.testing.assert_close(loss, loss_of(*leaves))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b)


def test_adamw_first_moment_gives_back_the_gradient():
    cfg = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.0, "clip_norm": 0.0, "warmup_steps": 0,
           "total_steps": 100, "min_lr_frac": 0.1}
    p = [torch.ones(3, dtype=torch.float64)]
    g = [torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)]
    z = [torch.zeros(3, dtype=torch.float64)]
    new, mu, _ = ref_fit.adamw(cfg, p, g, z, z, 0)
    torch.testing.assert_close(mu[0] / (1 - cfg["b1"]), g[0])
    # the first step moves every component by the rate, against its sign
    torch.testing.assert_close(new[0], 1 - 1e-3 * torch.sign(g[0]),
                               rtol=0, atol=1e-9)
