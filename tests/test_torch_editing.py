"""The port's INR editing modules against the reference's: gradient
features (plain and compiled), the INSP head, the image operators, the
encode / decode helpers and the editing bank's front door.

Both packages get the same SIREN (``siren.params_from_jax``) and INSP
weights (``insp.params_from_jax``) and the same numpy inputs; on the CPU
every kernel wrapper runs its plain version.  The port's fits draw from a
``torch.Generator``, so their parameters are not compared with the
reference's: a fit is checked by its loss falling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import InspConfig as JInspConfig
from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as JP
from repro.inr import editing as jediting
from repro.inr import encode as jencode
from repro.inr import gradnet as jgradnet
from repro.inr import insp as jinsp
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.configs.siren import InspConfig, SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.inr import editing, encode, gradnet, insp
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import BankArtifact
from test_torch_pipeline import _close_scaled

JSCFG = JSirenConfig(hidden_features=32, hidden_layers=2)
SCFG = SirenConfig(hidden_features=32, hidden_layers=2)


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    JP.clear_compile_cache()
    yield
    P.clear_compile_cache()


def _numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def siren():
    """(reference params, port params, reference fn, port fn)."""
    jp = j_siren_init(JSCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(_numpy(jp))
    return jp, tp, j_siren_fn(JSCFG, jp), siren_fn(SCFG, tp)


def _coords(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 2)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# gradient features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
def test_feature_vector_matches_reference(siren, order):
    _, _, jf, tf = siren
    x = _coords(40, seed=order)
    want = jgradnet.feature_vector(jf, order)(jnp.asarray(x))
    got = gradnet.feature_vector(tf, order)(torch.from_numpy(x))
    assert got.shape == (40, gradnet.num_features(2, 1, order))
    _close_scaled(got.detach(), want)


@pytest.mark.parametrize("order", [1, 2])
def test_compiled_feature_vector_matches_reference(siren, order):
    _, _, jf, tf = siren
    ex = _coords(64)
    jfeats, _ = jgradnet.compiled_feature_vector(jf, order, jnp.asarray(ex))
    feats, cg = gradnet.compiled_feature_vector(tf, order,
                                                torch.from_numpy(ex),
                                                device="cpu")
    assert cg.order == order
    x = _coords(50, seed=3)
    _close_scaled(feats(torch.from_numpy(x)), jfeats(jnp.asarray(x)))
    with pytest.raises(ValueError, match="order"):
        gradnet.feature_vector(tf, order + 1, compiled=cg)


def test_batched_gradients_and_num_features(siren):
    _, _, jf, tf = siren
    x = _coords(6, seed=4)
    want = jgradnet.batched_gradients(jf, 2)(jnp.asarray(x))
    got = gradnet.batched_gradients(tf, 2)(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(6, 1), (6, 1, 2), (6, 1, 2, 2)]
    for a, b in zip(got, want):
        _close_scaled(a.detach(), b)
    for d, c, k in [(2, 1, 0), (2, 1, 2), (3, 2, 3)]:
        assert gradnet.num_features(d, c, k) == jgradnet.num_features(d, c, k)


# ---------------------------------------------------------------------------
# the INSP head
# ---------------------------------------------------------------------------

def test_insp_apply_with_reference_psi(siren):
    _, _, jf, tf = siren
    icfg = JInspConfig(hidden=24, layers=3, grad_order=2)
    jpsi = jinsp.insp_init(icfg, 7, 1, jax.random.PRNGKey(3))
    psi = insp.params_from_jax(_numpy(jpsi))
    feats = np.random.RandomState(1).normal(size=(33, 7)).astype(np.float32)
    _close_scaled(insp.insp_apply(psi, torch.from_numpy(feats)),
                  jinsp.insp_apply(jpsi, jnp.asarray(feats)))
    x = _coords(9, seed=2)
    edited = insp.insp_pipeline(SCFG, InspConfig(24, 3, 2), tf)
    jedited = jinsp.insp_pipeline(JSCFG, icfg, jf)
    _close_scaled(edited(torch.from_numpy(x), psi).detach(),
                  jedited(jnp.asarray(x), jpsi))


def test_insp_init_shapes_and_scale():
    cfg = InspConfig()
    psi = insp.insp_init(cfg, 7, 1, torch.Generator().manual_seed(0))
    assert [tuple(p["w"].shape) for p in psi] == [(7, 64), (64, 64), (64, 1)]
    assert all(torch.equal(p["b"], torch.zeros_like(p["b"])) for p in psi)
    again = insp.insp_init(cfg, 7, 1, torch.Generator().manual_seed(0))
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(psi, again))


# ---------------------------------------------------------------------------
# image operators and the encode / decode helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [5, 16, 23])
def test_blur_and_sharpen_match_reference(res):
    """``jnp.convolve(mode="same")`` on both axes, edges included: an image
    narrower than the kernel (5 < 7 taps) comes out kernel-wide in both
    packages, and then has no sharpened version in either."""
    img = np.random.RandomState(res).rand(res, res).astype(np.float32)
    for sigma in (1.0, 1.5):
        np.testing.assert_allclose(
            editing.gaussian_blur(torch.from_numpy(img), sigma).numpy(),
            np.asarray(jediting.gaussian_blur(jnp.asarray(img), sigma)),
            rtol=0, atol=1e-6)
    if res < 7:
        with pytest.raises(RuntimeError):
            editing.sharpen(torch.from_numpy(img))
        return
    np.testing.assert_allclose(
        editing.sharpen(torch.from_numpy(img), 0.7).numpy(),
        np.asarray(jediting.sharpen(jnp.asarray(img), 0.7)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("res", [8, 24, 64, 256])
def test_image_coords_and_synthetic_image_match_reference(res):
    """Equal up to float32 rounding.  XLA may contract the reference's
    linspace arithmetic into an FMA, so a coordinate can differ in its last
    bit (at most 2**-23); the texture's slope (up to ~14) turns that into
    ~1e-6 of the image, beside the two libraries' own last-bit sin and
    exp."""
    coords = encode.image_coords(res)
    want = np.asarray(jencode.image_coords(res))
    assert coords.shape == want.shape == (res * res, 2)
    np.testing.assert_allclose(coords.numpy(), want, rtol=0, atol=2 ** -23)
    np.testing.assert_allclose(encode.synthetic_image(res).numpy(),
                               np.asarray(jencode.synthetic_image(res)),
                               rtol=0, atol=2e-6)


def test_encode_decode_roundtrip():
    cfg = SirenConfig(hidden_features=64, hidden_layers=2)
    img = encode.synthetic_image(24)
    params, mse = encode.encode_inr(cfg, img, steps=400, lr=3e-4,
                                    device="cpu")
    assert mse < 1e-2
    rec = encode.decode_inr(cfg, params, 24)
    assert float((rec - img).abs().mean()) < 0.1


# ---------------------------------------------------------------------------
# editing: fits, the edited INR and the bank front door
# ---------------------------------------------------------------------------

def test_train_insp_heads_loss_falls(siren):
    _, tp, _, _ = siren
    icfg = InspConfig(hidden=16, layers=2, grad_order=1)
    img = torch.from_numpy(
        np.random.RandomState(0).rand(8, 8).astype(np.float32))
    targets = {"a": img, "b": editing.gaussian_blur(img)}

    def fit(steps):
        return editing.train_insp_heads(
            SCFG, icfg, tp, targets, steps=steps, lr=1e-2, batch=64,
            generator=torch.Generator().manual_seed(0), device="cpu")

    first, last = fit(1), fit(60)
    assert sorted(last) == ["a", "b"]
    for name in last:
        assert last[name][1] < first[name][1]
    psi, mse = editing.train_insp_head(
        SCFG, icfg, tp, img, steps=60, lr=1e-2, batch=64,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert mse == pytest.approx(last["a"][1])
    with pytest.raises(ValueError, match="at least one"):
        editing.train_insp_heads(SCFG, icfg, tp, {}, device="cpu")


def test_edited_inr_matches_reference(siren, tmp_path):
    jp, tp, _, _ = siren
    icfg = JInspConfig(hidden=16, layers=2, grad_order=2)
    jpsi = jinsp.insp_init(icfg, 7, 1, jax.random.PRNGKey(5))
    psi = insp.params_from_jax(_numpy(jpsi))
    tcfg = InspConfig(16, 2, 2)
    x = _coords(30, seed=6)
    want = jediting.edited_inr(JSCFG, icfg, jp, jpsi)(jnp.asarray(x))
    pure = editing.edited_inr(SCFG, tcfg, tp, psi, device="cpu")
    _close_scaled(pure(torch.from_numpy(x)).detach(), want)
    served = editing.edited_inr(SCFG, tcfg, tp, psi, store=str(tmp_path),
                                example_coords=torch.from_numpy(_coords(64)),
                                device="cpu")
    _close_scaled(served(torch.from_numpy(x)), want)
    with pytest.raises(ValueError, match="example_coords"):
        editing.edited_inr(SCFG, tcfg, tp, psi, store=str(tmp_path),
                           device="cpu")


def test_editing_bank_front_door(siren):
    """train_insp_heads -> edited_bank -> edited_inr(bank=, head=name):
    the editing workload rides the bank API end to end, by filter name."""
    _, tp, _, _ = siren
    icfg = InspConfig(hidden=16, layers=2, grad_order=1)
    res = 8
    img = torch.from_numpy(
        np.random.RandomState(0).rand(res, res).astype(np.float32))
    heads = editing.train_insp_heads(SCFG, icfg, tp,
                                     {"a": img, "b": 1.0 - img}, steps=5,
                                     device="cpu")
    assert sorted(heads) == ["a", "b"]
    ex = encode.image_coords(res)
    bank, fns = editing.edited_bank(
        SCFG, icfg, tp, {n: psi for n, (psi, _) in heads.items()}, ex,
        device="cpu")
    assert isinstance(bank, BankArtifact) and bank.n_filters == 2
    x = ex[:13]
    g = editing.edited_inr(SCFG, icfg, tp, bank=bank, head="b")
    assert torch.equal(g(x), fns["b"](x))
    assert torch.equal(g(x), bank.apply_batched(x)[1])
    # the bank serves each head as its own feature pipeline + head would
    feats = gradnet.feature_vector(siren_fn(SCFG, tp), 1)(x).detach()
    for j, name in enumerate(bank.filter_ids):
        _close_scaled(bank.apply_batched(x)[j],
                      insp.insp_apply(heads[name][0], feats))
    with pytest.raises(ValueError, match="needs head"):
        editing.edited_inr(SCFG, icfg, tp, bank=bank)
    with pytest.raises(ValueError, match="BankArtifact"):
        editing.edited_inr(SCFG, icfg, tp, bank=bank.cg, head="b")


def test_editing_entry_points_raise_without_cuda(siren, monkeypatch):
    _, tp, _, _ = siren
    icfg = InspConfig(hidden=16, layers=2, grad_order=1)
    psi = insp.insp_init(icfg, 3, 1, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        editing.edited_bank(SCFG, icfg, tp, {"a": psi},
                            encode.image_coords(8))
    with pytest.raises(RuntimeError):
        encode.encode_inr(SCFG, encode.synthetic_image(8), steps=1)
