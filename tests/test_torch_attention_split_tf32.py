"""Split-TF32 products, emulated in plain torch, through attention.

The fp32 attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) run every product on the tensor cores in
TF32, which keeps 10 of fp32's 23 mantissa bits.  ``csrc/split_tf32.cuh``
writes each fp32 operand as hi + lo, both TF32 (hi rounded to nearest,
ties away: add half a TF32 ulp to the bits and clear the 13 low ones; lo
the exact rest, rounded the same way), and takes a . b as hi.hi + hi.lo +
lo.hi.  ``tf32_round``, ``tf32_split`` and ``split_matmul`` below repeat
that bit arithmetic and the kernels' folds: a score product (over the head
dim) folds every 8-deep k-step into fp32, a product over keys or q rows
every tile.  The kernels mirror this emulation; only the tensor cores' own
sums inside one k-step differ (they truncate, these round).

Attention forward and backward built from these products, at small shapes
(D = 16 and 64, causal and windowed, GQA, q shorter than k), are held to a
float64 evaluation at the fp32 tolerances the port's attention tests use:
3e-4 (rtol and atol) for the forward (``test_torch_flash_attention.py``),
1e-4 of the largest gradient for the backward (``test_torch_flash_cvjp.py``),
and at most twice the fp32 yardstick's error against float64 (the form of
``test_torch_flash_attention_bwd.py``'s rule): the reference's dense
``ref.flash_attention`` for the forward, ``flash_attention_bwd_plain`` (the
port of the reference's ``_bwd_impl``) for the backward.  Plain TF32, one
product hi.hi, misses those tolerances at these ordinary attention scales,
so dropping the split's small products cannot pass here.
``test_torch_flash_attention.py::_emulate_kernel`` replays the fp32
kernel's tile schedule through ``split_matmul``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa

SEED = 33
# the kernels' folds: score products every k-step of 8, products over keys
# (forward P V: 32-key tiles; backward dq: 16-key tiles) or over q rows
# (backward dk, dv: 16-row tiles) every tile
K_STEP, FWD_KEYS, BWD_TILE = 8, 32, 16
# (Sq, Sk, H, KH, D, window)
CASES = [(64, 64, 4, 2, 16, 0), (96, 96, 4, 2, 16, 8),
         (64, 64, 4, 2, 64, 0), (80, 80, 8, 2, 64, 24),
         (40, 100, 4, 1, 64, 0)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo), both TF32, hi + lo ~ x to 2^-22 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_matmul(a, b, chunk, products=3):
    """a [..., M, K] @ b [..., K, N] in fp32 from TF32 products, folded into
    fp32 every ``chunk`` of K: three products (hi.hi + hi.lo + lo.hi) or,
    with ``products=1``, plain TF32 (hi.hi)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], chunk):
        ks = slice(k0, k0 + chunk)
        part = ah[..., ks] @ bh[..., ks, :]
        if products == 3:
            part = (ah[..., ks] @ bl[..., ks, :]
                    + al[..., ks] @ bh[..., ks, :]) + part
        out = out + part
    return out


def _inputs(sq, sk, h, kh, d):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal((2, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (sk, kh), (sk, kh), (sq, h))]


def _heads(q, k, v):
    """[B, H, S, D] views, k and v repeated over each group of q heads."""
    G = q.shape[2] // k.shape[2]
    return (q.permute(0, 2, 1, 3),
            k.repeat_interleave(G, 2).permute(0, 2, 1, 3),
            v.repeat_interleave(G, 2).permute(0, 2, 1, 3))


def emulated_forward(q, k, v, window, products=3):
    """The forward's products as the kernel takes them (softmax in fp32)."""
    D, Sq, Sk = q.shape[3], q.shape[1], k.shape[1]
    qh, kh, vh = _heads(q, k, v)
    s = split_matmul(qh, kh.transpose(-1, -2), K_STEP, products) \
        * torch.tensor(1 / math.sqrt(D), dtype=torch.float32)
    s = torch.where(tfa._mask(Sq, Sk, True, window, "cpu"), s,
                    torch.tensor(tfa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = split_matmul(p, vh, FWD_KEYS, products) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def emulated_backward(q, k, v, out, lse, dout, window, products=3):
    """(dq, dk, dv) from the backward's products as its two passes take
    them; each q head's dk / dv share summed over the group in order."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    scale = torch.tensor(1 / math.sqrt(D), dtype=torch.float32)
    qh, kh, vh = _heads(q, k, v)
    gh = dout.permute(0, 2, 1, 3)
    dl = (dout * out).sum(-1).permute(0, 2, 1)[..., None]
    s = split_matmul(qh, kh.transpose(-1, -2), K_STEP, products)
    p = torch.where(tfa._mask(Sq, Sk, True, window, "cpu"),
                    torch.exp(s * scale - lse.permute(0, 2, 1)[..., None]),
                    torch.tensor(0.0))
    dp = split_matmul(gh, vh.transpose(-1, -2), K_STEP, products)
    ds = p * (dp - dl) * scale
    dq = split_matmul(ds, kh, BWD_TILE, products)
    dk = split_matmul(ds.transpose(-1, -2), qh, BWD_TILE, products)
    dv = split_matmul(p.transpose(-1, -2), gh, BWD_TILE, products)

    def fold(x):
        """[B, H, Sk, D] -> [B, Sk, KH, D], a group's heads in order."""
        x = x.reshape(B, KH, H // KH, Sk, D)
        acc = x[:, :, 0]
        for g in range(1, H // KH):
            acc = acc + x[:, :, g]
        return acc.permute(0, 2, 1, 3)
    return dq.permute(0, 2, 1, 3), fold(dk), fold(dv)


def _scaled(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _violation(got, want, tol):
    """max |got - want| / (tol + tol |want|): above 1 fails allclose."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


@pytest.mark.parametrize("bits", [0.0, 1.0, -1.0, 3.1415927, -2.7182817e-5,
                                  1.0000001, 123456.79, -6.1e-30])
def test_split_is_two_tf32_values_that_sum_to_x(bits):
    """hi and lo have their 13 low mantissa bits clear, |lo| <= half a TF32
    ulp of hi, and x - (hi + lo) is at most 2^-22 of x (x normal, and far
    enough from the subnormals that lo is normal too)."""
    x = torch.tensor([bits], dtype=torch.float32)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert int(part.view(torch.int32)) & 0x1FFF == 0
    assert abs(float(lo)) <= 2.0 ** -11 * abs(float(x)) + 1e-45
    assert abs(float(x) - (float(hi) + float(lo))) <= \
        2.0 ** -22 * abs(float(x))


def test_rounding_is_to_nearest_ties_away():
    """tf32_round on bit patterns: below half an ulp rounds down, half and
    above round away from zero, for both signs."""
    base = 0x3F800000                      # 1.0
    for low, up in ((0x0FFF, False), (0x1000, True), (0x1001, True)):
        for sign in (0, -0x80000000):
            x = torch.tensor([base + low + sign],
                             dtype=torch.int32).view(torch.float32)
            got = int(tf32_round(x).view(torch.int32)) - sign
            assert got == base + (0x2000 if up else 0), (low, sign)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_forward_holds_fp32_tolerance(case):
    """The split forward is within the fp32 attention tolerance of float64
    and within 2x the fp32 plain version's error; plain TF32 is not."""
    sq, sk, h, kh, d, window = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(sq, sk, h, kh, d))
    exact = tfa.flash_attention_plain(q.double(), k.double(), v.double(),
                                      window=window)
    plain = jref.flash_attention(*(jnp.asarray(a) for a in
                                   _inputs(sq, sk, h, kh, d)[:3]),
                                 causal=True, window=window)
    plain_err = float((torch.from_numpy(np.asarray(plain, np.float64))
                       - exact).abs().max())
    split = emulated_forward(q, k, v, window)
    tf32 = emulated_forward(q, k, v, window, products=1)
    assert _violation(split, exact, 3e-4) <= 1.0
    assert float((split.double() - exact).abs().max()) <= 2 * plain_err
    assert _violation(tf32, exact, 3e-4) > 1.0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_backward_holds_fp32_tolerance(case):
    """Each split gradient is within 1e-4 of the largest float64 gradient
    and within 2x the fp32 plain backward's error; plain TF32 is not."""
    sq, sk, h, kh, d, window = case
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(sq, sk, h, kh, d))
    out64, lse64 = tfa.flash_attention_plain(
        q.double(), k.double(), v.double(), window=window, return_lse=True)
    exact = tfa.flash_attention_bwd_plain(
        q.double(), k.double(), v.double(), out64, lse64, dout.double(),
        window=window)
    out, lse = out64.float(), lse64.float()
    plain = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                          window=window)
    split = emulated_backward(q, k, v, out, lse, dout, window)
    tf32 = emulated_backward(q, k, v, out, lse, dout, window, products=1)
    for name, s, t, p, e in zip(("dq", "dk", "dv"), split, tf32, plain,
                                exact):
        assert _scaled(s, e) <= 1e-4, name
        assert float((s.double() - e).abs().max()) <= \
            2 * float((p.double() - e).abs().max()), name
        assert _scaled(t, e) > 1e-4, name
