"""Port flash attention against the reference's, on the CPU.

On the CPU the port's `ops.flash_attention` runs its plain version
(`kernels.ref.flash_attention_ref`); the reference's runs its Pallas kernel
in interpret mode (slow on the CPU, so a few small cases).  The same numpy
inputs go through both.  Tolerances are `tests/test_kernels.py`'s: f32
2e-5, bf16 3e-2.  Causal cases with Sq > Sk hold the rows that have no
valid key at 0, as the Pallas kernel gives them.  `flash_decode_ref`, the
decode kernel's split-and-merge arithmetic in plain torch, is held
against the Pallas kernel too, with whole splits and rows masked.
`flash_route`, the rule between the three CUDA kernels, and
`decode_splits` are tested on both sides of each condition; the kernels
are held against the plain version on the card in
`tests/test_torch_gpu.py` and by `chip_smoke.py`.  A value head dim dv
apart from dk (MLA) is held against the Pallas kernel on v zero-padded
to dk (the output cropped) and against the reference's `_sdpa`, which
takes dv != dk natively; `flash_decode_ref` at dv != dk against the
plain version, and `flash_route` either side of the (192, 128) and
(192, 192) pairs.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import decode_splits, flash_route

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, b, h, kh, sq, sk, hd, dv=None):
    """q, k of head dim hd and v of head dim dv (default hd)."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((b, h, sq, hd))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, kh, sk, hd))).astype(np.float32)
    v = rng.standard_normal((b, kh, sk, dv or hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype, **kw):
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == q.shape
    return got.float().numpy(), (q, k, v)


# (G, causal, window, softcap, Sq, Sk, hd, dtype): GQA groups 1/2/4,
# causal and not, window 64, softcap 30, Sq < Sk, Sq = 1, hd 64 and 80; the
# next three are bf16 shapes the tensor-core route takes on CUDA (hd 64 and
# 128, Sq 17, window 1 and 63, softcap 50); the next three are causal with
# Sq > Sk, whose first Sq − Sk rows see no key (the last a decode-route
# shape); the last two are bf16 at hd 256 with MQA (group 8, one KV head)
# as gemma-2b's prefill, causal with Sq < Sk, and window 64 with softcap 30
CASES = [
    (1, True, None, None, 64, 64, 64, "float32"),
    (2, True, 64, 30.0, 128, 128, 64, "float32"),
    (4, False, None, None, 48, 112, 64, "float32"),
    (2, True, 64, None, 1, 100, 64, "float32"),
    (2, True, None, 30.0, 40, 72, 80, "float32"),
    (4, True, 64, 30.0, 70, 130, 80, "float32"),
    (2, True, 64, 30.0, 96, 96, 64, "bfloat16"),
    (1, False, None, 30.0, 1, 77, 80, "bfloat16"),
    (2, True, 63, 50.0, 37, 101, 128, "bfloat16"),
    (1, False, None, None, 17, 40, 64, "bfloat16"),
    (4, True, 1, None, 70, 70, 64, "bfloat16"),
    (2, True, None, None, 96, 40, 64, "float32"),
    (1, True, 16, None, 80, 64, 64, "bfloat16"),
    (2, True, None, None, 8, 3, 64, "float32"),
    (8, True, None, None, 40, 72, 256, "bfloat16"),
    (8, True, 64, 30.0, 96, 96, 256, "bfloat16"),
]


@pytest.mark.parametrize("group,causal,window,softcap,sq,sk,hd,dtype", CASES)
def test_flash_attention_matches_pallas(group, causal, window, softcap, sq,
                                        sk, hd, dtype):
    kh = 2 if group < 4 else 1
    q, k, v = _inputs(sq * 7 + sk + hd, 1, kh * group, kh, sq, sk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got, _ = _both(q, k, v, dtype, **kw)
    jdt = jnp.dtype(dtype)
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                  for a in (q, k, v)), qblk=64, kblk=64, **kw)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if causal and sq > sk:                 # no valid key: exactly 0
        assert not np.any(got[:, :, :sq - sk])


# Sq < Sk: there the reference's own plain version and its kernel agree
# (on rows with no valid key they differ, and the kernel is the contract)
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 64, 30.0), (False, None, 30.0),
    (False, 16, None)])
def test_flash_attention_ref_matches_reference_ref(group, causal, window,
                                                   softcap):
    q, k, v = _inputs(group, 2, 2 * group, 2, 50, 90, 32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  **kw)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_op_takes_strided_views_on_cpu():
    """The model hands over (B, S, H, hd) tensors transposed; the op's
    result does not depend on the layout.  In bf16 the shape is one the
    tensor-core route takes on CUDA; on the CPU no kernel launches."""
    q, k, v = _inputs(3, 2, 4, 2, 20, 20, 64)
    for dt in (torch.float32, torch.bfloat16):
        qt, kt, vt = (torch.from_numpy(a).to(dt) for a in (q, k, v))
        strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (qt, kt, vt)]
        a = ops.flash_attention(qt, kt, vt, window=8, softcap=30.0)
        b = ops.flash_attention(*strided, window=8, softcap=30.0)
        assert torch.equal(a, b)
    assert flash_route(torch.bfloat16, 20, 64) == "tc"
    assert ops.LAUNCHES["flash_attention"] == 0     # no kernel on the CPU
    assert ops.LAUNCHES["flash_attention_tc"] == 0
    assert ops.LAUNCHES["flash_attention_decode"] == 0


# the decode kernel's split-and-merge arithmetic (`flash_decode_ref`)
# against the Pallas kernel and the plain version: Sk 40 (window 5, shorter
# than a split of 7 or Sk, masks whole splits) and Sk 2 (causal: with
# Sq 3 and 16 the first rows see no key; with 7 or Sk splits the last are
# empty)
DECODE_MASKS = [(False, None, None, "float32"),
                (True, 5, 30.0, "float32"),
                (True, None, None, "bfloat16")]


@functools.lru_cache(maxsize=None)
def _decode_case(sq, group, sk, causal, window, softcap, dtype):
    """Inputs and the Pallas kernel's result (interpret mode), shared by
    the n_split cases."""
    q, k, v = _inputs(sq * 31 + group + sk, 1, 2 * group, 2, sq, sk, 32)
    jdt = jnp.dtype(dtype)
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                  for a in (q, k, v)), qblk=64, kblk=64,
                                causal=causal, window=window, softcap=softcap)
    return (q, k, v), np.asarray(want, np.float32)


@pytest.mark.parametrize("n_split", [1, 2, 7, "sk"])
@pytest.mark.parametrize("sq", [1, 3, 16])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_decode_ref_matches_pallas(n_split, sq, group):
    for sk in (40, 2):
        for causal, window, softcap, dtype in DECODE_MASKS:
            kw = dict(causal=causal, window=window, softcap=softcap)
            (q, k, v), want = _decode_case(sq, group, sk, causal, window,
                                           softcap, dtype)
            tdt = getattr(torch, dtype)
            qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
            got = ref.flash_decode_ref(
                qt, kt, vt, n_split=sk if n_split == "sk" else n_split, **kw)
            assert got.dtype == tdt and got.shape == qt.shape
            got = got.float().numpy()
            tol = TOL[dtype]
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
            plain = ref.flash_attention_ref(qt, kt, vt, **kw).float().numpy()
            np.testing.assert_allclose(got, plain, rtol=tol, atol=tol)
            if causal and sq > sk:
                assert not np.any(got[:, :, :sq - sk])


# decode_splits: floor(3·n_sm / (B·Kh)), at most ceil(Sk / 128), at least
# 1; each clamp and the floor from both sides
@pytest.mark.parametrize("b,kh,sk,n_sm,want", [
    (2, 16, 4609, 132, 12),      # the [lm] global decode: 384 blocks
    (2, 16, 4096, 132, 12),      # the [lm] local (wrapped ring) decode
    (2, 66, 4609, 132, 3),       # 396 blocks: three a SM
    (2, 67, 4609, 132, 2),       # 3·132 / 134 is 2.96: floor
    (1, 1, 4609, 132, 37),       # capped by Sk / 128
    (1, 1, 4736, 132, 37),       # 37 · 128 keys: still 37
    (1, 1, 4737, 132, 38),
    (1, 8, 100, 132, 1),         # short cache: one split
    (1, 8, 129, 132, 2),
    (64, 16, 4609, 132, 1),      # more (b, kh) pairs than 3 a SM: one
    (1, 1, 1, 1, 1),
])
def test_decode_splits(b, kh, sk, n_sm, want):
    assert decode_splits(b, kh, sk, n_sm) == want


# the rule between the three CUDA kernels: the decode kernel iff Sq <= 16;
# else the tensor-core kernel iff bf16 and head_dim 64, 80, 128 or 256;
# else the CUDA-core kernel; each condition on both sides
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq", [1, 16, 17, 4608])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_route(dtype, sq, hd):
    want = ("decode" if sq <= 16 else
            "tc" if dtype == torch.bfloat16 and hd in (64, 80, 128, 256)
            else "cuda_core")
    assert flash_route(dtype, sq, hd) == want



# ---------------------------------------------------------------------------
# a value head dim dv apart from the query/key head dim dk (MLA's naive
# path: dk = qk_nope + rope, dv = v_head_dim).  The Pallas kernel takes
# dk == dv only: v zero-padded to dk and the output cropped to dv is the
# same function.  (G, causal, window, softcap, Sq, Sk, dk, dv, dtype):
# the smoke config's (dk 24, dv 16; prefill and a decode step), MLA's
# published pair at Kh = H (bf16, causal with Sq < Sk) and a capped,
# windowed GQA case with dv > dk
DV_CASES = [
    (1, True, None, None, 40, 40, 24, 16, "float32"),
    (1, True, None, None, 1, 41, 24, 16, "float32"),
    (1, True, None, None, 24, 60, 192, 128, "bfloat16"),
    (2, True, 16, 30.0, 33, 50, 32, 48, "float32"),
]


@pytest.mark.parametrize("group,causal,window,softcap,sq,sk,dk,dv,dtype",
                         DV_CASES)
def test_flash_attention_dv_matches_pallas_and_sdpa(group, causal, window,
                                                    softcap, sq, sk, dk, dv,
                                                    dtype):
    kh = 2 if group < 4 else 1
    q, k, v = _inputs(sq + sk + dk + dv, 1, kh * group, kh, sq, sk, dk, dv)
    kw = dict(causal=causal, window=window, softcap=softcap)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == (1, kh * group, sq, dv)
    got = got.float().numpy()
    tol = TOL[dtype]
    jdt = jnp.dtype(dtype)
    pad = max(dk, dv)
    widen = lambda a: np.pad(a, ((0, 0),) * 3 + ((0, pad - a.shape[-1]),))
    # the Pallas kernel scales by 1/sqrt of its head dim: q carries the
    # ratio when dv > dk widens q and k past dk
    qs = widen(q) * np.float32(np.sqrt(pad / dk))
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                  for a in (qs, widen(k), widen(v))),
                                qblk=64, kblk=64, **kw)
    np.testing.assert_allclose(got, np.asarray(want, np.float32)[..., :dv],
                               rtol=tol, atol=tol)
    # the reference's own attention takes hd' != hd natively
    q_pos = jnp.arange(sq)[None] + (sk - sq)
    k_pos = jnp.arange(sk)[None]
    bias = jattn.mask_bias(q_pos, k_pos, kind="causal" if causal else "full",
                           window=window)
    sd = jattn._sdpa(*(jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jdt)
                       for a in (q, k, v)), bias, softcap, jdt)
    sd = np.asarray(sd, np.float32).transpose(0, 2, 1, 3)
    live = np.arange(sq) + (sk - sq) >= 0    # rows with a valid key
    np.testing.assert_allclose(got[:, :, live], sd[:, :, live], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n_split", [1, 3, "sk"])
@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
def test_flash_decode_ref_dv(n_split, dk, dv):
    """The decode kernel's split-and-merge arithmetic at dv != dk against
    the plain version, a window masking whole splits."""
    q, k, v = _inputs(dk + dv, 2, 4, 4, 3, 70, dk, dv)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    for kw in (dict(causal=True), dict(causal=True, window=9,
                                       softcap=30.0)):
        got = ref.flash_decode_ref(qt, kt, vt, n_split=70 if n_split == "sk"
                                   else n_split, **kw)
        assert got.shape == (2, 4, 3, dv)
        np.testing.assert_allclose(
            got.numpy(), ref.flash_attention_ref(qt, kt, vt, **kw).numpy(),
            rtol=2e-5, atol=2e-5)


# MLA's (dk 192, dv 128) and nemotron's (192, 192) take the tensor cores
# in bf16; the pair with 128 on the key side only, (256, 128) and f32 do
# not
@pytest.mark.parametrize("dtype,sq,dk,dv,want", [
    (torch.bfloat16, 4064, 192, 128, "tc"),
    (torch.bfloat16, 4064, 192, 192, "tc"),
    (torch.bfloat16, 4064, 128, 192, "cuda_core"),
    (torch.bfloat16, 4064, 256, 128, "cuda_core"),
    (torch.float32, 4064, 192, 128, "cuda_core"),
    (torch.bfloat16, 17, 192, 128, "tc"),
    (torch.bfloat16, 16, 192, 128, "decode"),
    (torch.float32, 1, 24, 16, "decode"),
    (torch.float32, 40, 24, 16, "cuda_core"),
])
def test_flash_route_dv(dtype, sq, dk, dv, want):
    assert flash_route(dtype, sq, dk, dv) == want
