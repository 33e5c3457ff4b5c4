"""The port's attention and scan kernels against the reference's.

On the CPU ``kernels.flash_attention.flash_attention`` and
``kernels.ssd_scan.ssd_scan`` run their plain versions; here each is held,
on the same numpy inputs, against the reference Pallas kernel in interpret
mode and against the reference's pure-jnp oracle (``repro.kernels.ref``).
fp32 is held at the reference's own tolerance (``tests/test_kernels.py``:
3e-4 for attention, 1e-5 for the scan).  In bf16 both sides round P and
the output, at different points, so each is measured against a float64
evaluation and the port's error may be at most twice the reference's.

``_emulate_kernel`` repeats the CUDA kernels' schedules in plain torch, with
the tile sizes the wrapper exports (``KERNEL_TILES``): the q and kv tiles,
the tiles they skip, bf16 rounding of P and, for the bf16 tensor-core
kernel, the base-2 softmax and the per-warpgroup choice of the kv tiles that
need a mask; for the fp32 kernel, its split-TF32 products
(``test_torch_attention_split_tf32.split_matmul``).  So the tiling, skipping
and masking logic of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_tc.cu`` is checked here although the kernels run
only on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash_kernel
from repro.kernels.ssd_scan import ssd_scan as j_ssd_kernel
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import layers as tlayers
from test_torch_attention_split_tf32 import K_STEP, split_matmul

SEED = 77


def _qkv(sq, sk, h, kh, d, seed=0):
    rng = np.random.default_rng(SEED + seed)
    return [rng.standard_normal((2, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (sk, kh), (sk, kh))]


def _to_j(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _to_t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _oracle(q, k, v, *, causal, window):
    """float64 attention on the (rounded) inputs."""
    return tfa.flash_attention_plain(q.double(), k.double(), v.double(),
                                     causal=causal, window=window).numpy()


def _err(a, b):
    return float(np.abs(_f64(a) - np.asarray(b, np.float64)).max())


def _emulate_kernel(q, k, v, *, causal=True, window=0):
    """The CUDA kernels' schedules in plain torch: per (b, h, q tile) the kv
    tile range of the kernel, online softmax per kv tile, P rounded to v's
    dtype, l over the unrounded P.  fp32 (csrc/flash_attention.cu) takes
    its products in split TF32 (scores folded every k-step of 8, P V every
    tile) and exp of scores scaled by 1/sqrt(D), masking every tile.  bf16
    (csrc/flash_attention_tc.cu) scales by log2(e)/sqrt(D), takes exp2, and
    each 64-row consumer warpgroup masks only the kv tiles that straddle the
    diagonal, the window edge or Sk: on every other tile the mask it skips
    must be all true, which is asserted here."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    BQ, BK = tfa.KERNEL_TILES[q.dtype][D]
    tc = q.dtype == torch.bfloat16
    if tc:
        scale, exp = tfa.LOG2E / math.sqrt(D), torch.exp2
    else:
        scale, exp = 1.0 / math.sqrt(D), torch.exp
    scale = torch.tensor(scale, dtype=torch.float32)  # the kernel's float
    out = torch.zeros_like(q)
    q_offset = Sk - Sq
    for q0 in range(0, Sq, BQ):
        rows = min(BQ, Sq - q0)
        qp_lo, qp_hi = q_offset + q0, q_offset + q0 + rows - 1
        k_end = min(Sk, qp_hi + 1) if causal else Sk
        k_begin = max(0, qp_lo - window + 1) // BK * BK if window > 0 else 0
        qpos = qp_lo + torch.arange(rows)
        qt = q[:, q0:q0 + rows].float()                     # [B, r, H, D]
        m = torch.full((B, H, rows), -1e30)
        l = torch.zeros((B, H, rows))
        acc = torch.zeros((B, H, rows, D))
        for k0 in range(k_begin, k_end, BK):
            kt = k[:, k0:k0 + BK].float().repeat_interleave(G, dim=2)
            vt = v[:, k0:k0 + BK].float().repeat_interleave(G, dim=2)
            kpos = k0 + torch.arange(kt.shape[1])
            if tc:
                s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * scale
            else:
                s = split_matmul(qt.permute(0, 2, 1, 3),
                                 kt.permute(0, 2, 3, 1), K_STEP) * scale
            ok = (kpos < Sk)[None, :].expand(rows, -1)
            if causal:
                ok = ok & (qpos[:, None] >= kpos[None, :])
            if window > 0:
                ok = ok & ((qpos[:, None] - kpos[None, :]) < window)
            for w0 in range(0, rows, 64) if tc else ():
                wg_lo = qp_lo + w0
                edge = (k0 + BK > Sk or (causal and k0 + BK - 1 > wg_lo)
                        or (window > 0 and wg_lo + 63 - k0 >= window))
                assert edge or bool(ok[w0:w0 + 64].all()), (q0, w0, k0)
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = exp(m - m_new)
            p = exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                              vt) if tc else split_matmul(
                p, vt.permute(0, 2, 1, 3), BK)
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


ATTN_SHAPES = {
    "mha": (64, 64, 4, 4, 64),
    "gqa4": (64, 64, 8, 2, 64),
    "mqa_q_lt_k": (32, 128, 4, 1, 64),
    "ragged_d96": (50, 77, 4, 2, 96),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_flash_attention_matches_reference(shape, window, dtype):
    """The wrapper (plain on the CPU) against the reference Pallas kernel
    (interpret mode, 16 x 32 blocks so every length is ragged or tiled) and
    the reference's dense oracle."""
    a = _qkv(*ATTN_SHAPES[shape])
    jq, jk, jv = (_to_j(x, dtype) for x in a)
    tq, tk, tv = (_to_t(x, dtype) for x in a)
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kern = j_flash_kernel(jq, jk, jv, causal=True, window=window, bq=16,
                          bk=32, interpret=True)
    dense = jref.flash_attention(jq, jk, jv, causal=True, window=window)
    if dtype == "float32":
        for want in (kern, dense):
            np.testing.assert_allclose(_f64(got), _f64(want), rtol=3e-4,
                                       atol=3e-4)
    else:
        exact = _oracle(tq, tk, tv, causal=True, window=window)
        ref_err = max(_err(kern, exact), _err(dense, exact))
        assert ref_err > 0
        assert _err(got, exact) <= 2 * ref_err, (_err(got, exact), ref_err)


EMU_CASES = [
    (200, 200, 4, 2, 64, 0, "float32"),
    (200, 200, 4, 2, 64, 16, "float32"),
    (100, 230, 8, 2, 96, 0, "float32"),
    (100, 230, 8, 2, 96, 40, "float32"),
    (130, 130, 2, 2, 128, 64, "float32"),
    (70, 70, 4, 4, 256, 33, "float32"),
    (200, 200, 8, 2, 128, 0, "bfloat16"),
    (150, 181, 4, 1, 64, 50, "bfloat16"),
    # bf16 lengths that are not multiples of its 128- / 64-key tiles
    (200, 300, 8, 2, 128, 0, "bfloat16"),
    (181, 181, 4, 4, 96, 0, "bfloat16"),
    (70, 250, 4, 2, 256, 0, "bfloat16"),
    # the reduced configs' head dim (one 64-column slab, 16 stored)
    (150, 150, 4, 2, 16, 8, "bfloat16"),
    (90, 90, 4, 2, 16, 0, "float32"),
    # windows that make the bf16 kernel skip whole kv tiles
    (600, 600, 4, 2, 64, 100, "bfloat16"),
    (300, 300, 2, 1, 256, 70, "bfloat16"),
    (330, 400, 4, 2, 96, 129, "bfloat16"),
]


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_schedule_matches_reference(case):
    """The CUDA kernel's tiling and tile skipping change no result."""
    sq, sk, h, kh, d, window, dtype = case
    a = _qkv(sq, sk, h, kh, d, seed=1)
    tq, tk, tv = (_to_t(x, dtype) for x in a)
    got = _emulate_kernel(tq, tk, tv, causal=True, window=window)
    dense = jref.flash_attention(*(_to_j(x, dtype) for x in a), causal=True,
                                 window=window)
    if dtype == "float32":
        np.testing.assert_allclose(_f64(got), _f64(dense), rtol=3e-4,
                                   atol=3e-4)
    else:
        exact = _oracle(tq, tk, tv, causal=True, window=window)
        assert _err(got, exact) <= 2 * _err(dense, exact)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_tiles_cover_every_head_dim(dtype):
    """Each kernel has a (q rows, kv keys) tile for every head dim the
    wrapper accepts; the bf16 tiles fit the tensor-core kernel (two 64-row
    warpgroups, 16-key wgmma steps)."""
    tiles = tfa.KERNEL_TILES[dtype]
    assert set(tiles) == set(tfa.HEAD_DIMS)
    for d, (bq, bk) in tiles.items():
        assert bq > 0 and bk > 0, d
        if dtype == torch.bfloat16:
            assert bq == 128 and bk % 16 == 0 and bk <= 128, (d, bq, bk)


def test_kernel_schedule_skips_whole_bf16_tiles():
    """The skipping cases of ``EMU_CASES`` do skip: some bf16 q tile starts
    its kv loop past key 0."""
    for sq, sk, _, _, d, window, dtype in EMU_CASES:
        if dtype != "bfloat16" or window == 0 or sq < 300:
            continue
        bq, bk = tfa.KERNEL_TILES[torch.bfloat16][d]
        begins = [max(0, sk - sq + q0 - window + 1) // bk * bk
                  for q0 in range(0, sq, bq)]
        assert max(begins) > 0, (sq, sk, d, window, begins)


@pytest.mark.parametrize("window,q_offset,blocks", [
    (0, None, (16, 32)), (8, None, (16, 16)), (0, 40, (32, 32)),
    (24, 10, (8, 64))])
def test_blockwise_layer_matches_reference(window, q_offset, blocks):
    """``models.layers.flash_attention`` (the port's ``attn_impl="flash"``)
    against the reference's blockwise layer: q shorter than k, ragged
    blocks, q_offset."""
    q, k, v = _qkv(60, 90, 8, 2, 16, seed=2)
    qb, kb = blocks
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   q_offset=q_offset, q_block=qb,
                                   kv_block=kb)
    got = tlayers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window, q_offset=q_offset,
                                  q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_blockwise_layer_matches_kernel_plain_bf16():
    """bf16 blockwise layer and the kernel's plain version: both within
    twice the reference layer's error of float64."""
    a = _qkv(96, 96, 4, 2, 64, seed=3)
    tq, tk, tv = (_to_t(x, "bfloat16") for x in a)
    exact = _oracle(tq, tk, tv, causal=True, window=0)
    want = jlayers.flash_attention(*(_to_j(x, "bfloat16") for x in a),
                                   causal=True, q_block=32, kv_block=32)
    ref_err = _err(want, exact)
    for got in (tlayers.flash_attention(tq, tk, tv, q_block=32, kv_block=32),
                tfa.flash_attention(tq, tk, tv)):
        assert _err(got, exact) <= 2 * ref_err


@pytest.mark.parametrize("bh,nc,p,n,dtype", [
    (4, 8, 16, 8, "float32"), (1, 1, 4, 4, "float32"),
    (12, 3, 8, 16, "float32"), (3, 5, 7, 9, "float32"),
    (4, 8, 16, 8, "bfloat16")])
def test_ssd_scan_matches_reference(bh, nc, p, n, dtype):
    rng = np.random.default_rng(SEED + bh)
    st = rng.standard_normal((bh, nc, p, n)).astype(np.float32)
    dec = (1 / (1 + np.exp(-rng.standard_normal((bh, nc))))).astype(
        np.float32)
    jst, tst = _to_j(st, dtype), _to_t(st, dtype)
    got = ssd_scan(tst, torch.from_numpy(dec))
    assert got.dtype == torch.float32 and got.shape == (bh, nc, p, n)
    for want in (j_ssd_kernel(jst, jnp.asarray(dec), interpret=True),
                 jref.ssd_scan(jst, jnp.asarray(dec))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_ssd_scan_plain_is_the_recurrence():
    """prev[0] = 0 and prev[c + 1] = decay_c prev[c] + states_c."""
    rng = np.random.default_rng(SEED)
    st = torch.from_numpy(rng.standard_normal((2, 6, 3, 4)).astype(
        np.float32))
    dec = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 6)).astype(np.float32))
    prev = ssd_scan_plain(st, dec)
    assert torch.equal(prev[:, 0], torch.zeros(2, 3, 4))
    for c in range(5):
        assert torch.equal(prev[:, c + 1],
                           prev[:, c] * dec[:, c, None, None] + st[:, c])


def test_ops_exports_the_five_wrappers():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_chain import fused_chain
    from repro_torch.kernels.siren_layer import siren_layer
    from repro_torch.kernels.stream_matmul import stream_matmul
    assert set(ops.__all__) == {"stream_matmul", "siren_layer", "fused_chain",
                                "flash_attention", "ssd_scan", "ref"}
    assert ops.flash_attention is flash_attention
    assert ops.ssd_scan is ssd_scan
    assert ops.stream_matmul is stream_matmul
    assert ops.siren_layer is siren_layer
    assert ops.fused_chain is fused_chain
    assert ops.ref.flash_attention is tfa.flash_attention_plain
    assert ops.ref.ssd_scan is ssd_scan_plain
    x = torch.rand(5, 7)
    e = torch.rand(5, 7)
    chain = (("sin", None), ("mul", None))
    assert torch.equal(ops.fused_chain(x, chain, [e]),
                       ops.ref.fused_chain(x, chain, [e]))
    a, w = torch.rand(5, 3), torch.rand(3, 4)
    assert torch.equal(ops.stream_matmul(a, w), ops.ref.stream_matmul(a, w))


def test_wrappers_on_cpu_take_the_plain_versions():
    q, k, v = (torch.from_numpy(x) for x in _qkv(40, 40, 4, 2, 64))
    assert torch.equal(tfa.flash_attention(q, k, v, window=7),
                       tfa.flash_attention_plain(q, k, v, window=7))
    st, dec = torch.rand(2, 3, 4, 5), torch.rand(2, 3)
    assert torch.equal(ssd_scan(st, dec), ssd_scan_plain(st, dec))


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 8, 6, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 8, 4, 64),
                            torch.zeros(1, 8, 4, 64))   # 6 heads onto 4
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32))   # head dims differ
    with pytest.raises(ValueError):
        ssd_scan(torch.zeros(2, 3, 4, 5), torch.zeros(2, 4))
