"""CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  The file imports no JAX, so it also runs where JAX is
not installed (without the suite's conftest, which imports it):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py's: f32 1e-5, bf16 2e-2, Δ rtol 1e-4 /
atol 1e-2; flash attention f32 2e-5, bf16 3e-2 (all three of its
kernels: the split-key decode one takes Sq <= 16, the tensor-core one
bf16 prefill, the CUDA-core one the other prefills), each element and
each output row relative to its norm, on logits inside and past the
softcaps (there, the kernel without its softcap must fail), with causal
Sq > Sk cases whose first rows see no key (0).  The decode and CUDA-core
kernels are also held bitwise against themselves across calls, the f32
CUDA-core kernel against float64 attention within twice the plain
version's own error, and the channel kernels bitwise against their plain
versions on every row, zero, NaN, ±inf, denormal and all-NaN rows
included (the QSGD row pass's three epilogues on both of its paths, the
QSGD stream on odd D and misaligned arrays, the top-k kernel on each of
its three paths, and against its multi-level walk
`ref.topk_threshold_tree_ref`).  The mix of a ragged leaf set in one
launch is held bitwise against one-leaf calls and the Gram bitwise
against itself, with Δ bitwise `ref.sqdist_from_gram` of its G.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_tc_cuda,
                                                 flash_decode_cuda,
                                                 flash_route)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,d", [(1, 20, 47571), (4, 20, 47571),
                                   (20, 20, 47571), (100, 100, 4099),
                                   (3, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixing_aggregate_kernel_matches_plain(k, m, d, dtype):
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(k + m)
    w = torch.rand((k, m), generator=gen, device="cuda")
    w = w / w.sum(1, keepdim=True)
    theta = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = ops.mixing_aggregate(w, theta)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mixing_aggregate"] == n0 + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               ref.mixing_aggregate_ref(w, theta).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(20, 47571), (100, 47571), (17, 31)])
def test_gram_kernel_matches_plain(m, d):
    _require_cuda()
    g = torch.randn((m, d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(m))
    torch.testing.assert_close(ops.gram_matrix(g), ref.gram_ref(g),
                               rtol=1e-4, atol=1e-2)
    got = ops.pairwise_sqdist(g)
    torch.cuda.synchronize()
    # assembled from the plain Gram, as the kernel path is (the separately
    # summed norms of pairwise_sqdist_ref leave ~1e-2 on its diagonal here)
    torch.testing.assert_close(got, ref.sqdist_from_gram(ref.gram_ref(g)),
                               rtol=1e-4, atol=1e-2)
    assert torch.equal(got, got.T)
    assert torch.all(torch.diagonal(got) == 0)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _require_cuda()
    theta = torch.randn((4, 9), device="cuda")
    with pytest.raises(TypeError):
        ops.mixing_aggregate(torch.ones(2, 4, device="cuda"),
                             theta.to(torch.float16))
    with pytest.raises(ValueError):
        ops.mixing_aggregate(torch.ones(2, 5, device="cuda"), theta)
    with pytest.raises(ValueError):
        ops.mixing_aggregate(torch.ones(2, 9, device="cuda"), theta.T)


# ---------------------------------------------------------------------------
# the mix of a whole tree in one launch, the Gram and Δ in one launch

RAGGED = (1, 6, 47, 127, 128, 129, 150, 4099)


def _nan_landing(n, dtype):
    """Fill a fresh n-element block with NaN and free it, so the op's first
    allocation (its output) lands on NaN: a skipped element stays NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = torch.full((n,), float("nan"), dtype=dtype, device="cuda")
    ptr = t.data_ptr()
    del t
    return ptr


def _ragged_leaves(gen, m, dtype, n_leaves):
    """n_leaves (m, d) leaves cycling through RAGGED, every other one at a
    base one element past an aligned address (rows 4- or 2-byte aligned)."""
    out = []
    for i in range(n_leaves):
        d = RAGGED[i % len(RAGGED)]
        flat = torch.randn(m * d + 1, generator=gen, device="cuda").to(dtype)
        out.append(flat[i % 2:i % 2 + m * d].view(m, d))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,n_leaves", [(20, 20, 8), (100, 100, 8),
                                          (3, 5, 41), (130, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_leaves_ragged(k, m, n_leaves, dtype):
    """A ragged leaf set (widths 1..4,099, misaligned bases, more than
    N_MAX leaves) in one call: within tolerance of the plain version,
    bitwise equal to one-leaf calls, no element left unwritten."""
    _require_cuda()
    from repro_torch.kernels.mixing_aggregate import N_MAX
    gen = torch.Generator(device="cuda").manual_seed(k * 7 + m)
    w = torch.rand((k, m), generator=gen, device="cuda")
    w = w / w.sum(1, keepdim=True)
    thetas = _ragged_leaves(gen, m, dtype, n_leaves)
    a = 16 // thetas[0].element_size()
    total = sum(-(-k * t.shape[1] // a) * a for t in thetas)
    ptr = _nan_landing(total, dtype)
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = ops.mixing_aggregate_leaves(w, thetas)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == ptr
    assert ops.LAUNCHES["mixing_aggregate"] == n0 + -(-n_leaves // N_MAX)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, t in zip(got, thetas):
        assert g.shape == (k, t.shape[1]) and g.dtype == dtype
        assert not torch.isnan(g).any()
        torch.testing.assert_close(g.float(),
                                   ref.mixing_aggregate_ref(w, t).float(),
                                   rtol=tol, atol=tol)
        assert torch.equal(g, ops.mixing_aggregate(w, t))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [20, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_leaves_identity_is_bitwise(m, dtype):
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m)
    thetas = _ragged_leaves(gen, m, dtype, 8)
    got = ops.mixing_aggregate_leaves(torch.eye(m, device="cuda"), thetas)
    for g, t in zip(got, thetas):
        assert torch.equal(g, t)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_folded_stream_aggregate_is_bitwise_gather_form(k):
    """centroids[assignment] mixed once equals mixing to the k centroids
    and gathering each client's row, bit for bit (one launch, not two)."""
    _require_cuda()
    from repro_torch.core import StreamPlan, mix_pytree, stream_aggregate
    gen = torch.Generator(device="cuda").manual_seed(k)
    m = 20
    cents = torch.rand((k, m), generator=gen, device="cuda")
    cents = cents / cents.sum(1, keepdim=True)
    assign = torch.randint(0, k, (m,), generator=gen, device="cuda")
    stacked = {f"leaf{i}": t for i, t in enumerate(
        _ragged_leaves(gen, m, torch.float32, 8))}
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = stream_aggregate(stacked, StreamPlan(cents, assign,
                                               torch.tensor(0.0)))
    assert ops.LAUNCHES["mixing_aggregate"] == n0 + 1
    mixed = mix_pytree(stacked, cents)
    for name, v in mixed.items():
        assert torch.equal(got[name], v[assign])


GRAM_MS = (1, 17, 20, 32, 33, 100, 129)


@pytest.mark.gpu
@pytest.mark.parametrize("m", GRAM_MS)
@pytest.mark.parametrize("d", [31, 4096, 47571])
def test_gram_one_launch_deterministic(m, d):
    """G within tolerance of the plain Gram, exactly symmetric and bitwise
    equal across calls; Δ bitwise `sqdist_from_gram` of that G, with a
    zero diagonal; one launch a call, every element written."""
    _require_cuda()
    from repro_torch.kernels.pairwise_sqdist import gram_sqdist_cuda
    g = torch.randn((m, d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(d))
    ptr = _nan_landing(2 * m * m, torch.float32)
    gram, delta = gram_sqdist_cuda(g)
    torch.cuda.synchronize()
    assert gram.data_ptr() == ptr
    assert not torch.isnan(gram).any() and not torch.isnan(delta).any()
    torch.testing.assert_close(gram, ref.gram_ref(g), rtol=1e-4, atol=1e-2)
    assert torch.equal(gram, gram.T)
    assert torch.equal(delta, ref.sqdist_from_gram(gram))
    assert torch.all(torch.diagonal(delta) == 0)
    n0 = ops.LAUNCHES["gram_matrix"]
    for _ in range(3):
        assert torch.equal(ops.gram_matrix(g), gram)
        assert torch.equal(ops.pairwise_sqdist(g), delta)
    assert ops.LAUNCHES["gram_matrix"] == n0 + 6


@pytest.mark.gpu
def test_gram_counters_are_keyed_by_stream():
    """Two streams each get their own ticket counters; launches in flight
    on both at once give each stream's exact answer, and every counter is
    back at 0."""
    _require_cuda()
    from repro_torch.kernels import pairwise_sqdist as P
    gen = torch.Generator(device="cuda").manual_seed(5)
    gs = [torch.randn((20, 47571), generator=gen, device="cuda")
          for _ in range(2)]
    want = [ops.gram_matrix(g) for g in gs]
    streams = [torch.cuda.Stream() for _ in gs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (s, g) in enumerate(zip(streams, gs)):
            with torch.cuda.stream(s):
                got[i].append(ops.gram_matrix(g))
    torch.cuda.synchronize()
    for i, s in enumerate(streams):
        assert all(torch.equal(x, want[i]) for x in got[i])
        assert (gs[i].device.index, s.cuda_stream) in P._COUNTERS
    assert all(int(c.abs().sum()) == 0 for c in P._COUNTERS.values())


# ---------------------------------------------------------------------------
# channel kernels: bitwise equal to their plain versions (kernels/ref.py
# repeats their f32 arithmetic op for op)


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _bits(t):
    """The bit patterns of a float tensor (NaN payloads included)."""
    return t.view(torch.int32)


def _qsgd_rows(m, d, gen):
    """x, u (m, D) on the card: row 0 random; rows 1..10, as m allows, all
    zero, a NaN coordinate, +inf, -inf, denormal, all NaN, ±1e-37 (scale
    subnormal at bits 8), ±0.5 with one 1.7e38 (inv subnormal at bits 2),
    all 1e-40 (absmax subnormal) and 2e-36 with subnormal odd elements
    (normal scalars); the rest random."""
    x = torch.randn((m, d), generator=gen, device="cuda") * 3
    u = torch.rand((m, d), generator=gen, device="cuda")
    cases = ["zero", "nan", "+inf", "-inf", "denormal", "all_nan",
             "scale_subnormal", "inv_subnormal", "all_subnormal",
             "subnormal_elements"]
    for i, case in enumerate(cases[:m - 1], start=1):
        if case == "zero":
            x[i] = 0.0
        elif case == "nan":
            x[i, d // 2] = float("nan")
        elif case == "+inf":
            x[i, d - 1] = float("inf")
        elif case == "-inf":
            x[i, 0] = float("-inf")
        elif case == "denormal":
            x[i] *= 1e-39
        elif case == "all_nan":
            x[i] = float("nan")
        elif case == "scale_subnormal":
            x[i] = torch.sign(x[i]) * 1e-37
        elif case == "inv_subnormal":
            x[i] = torch.sign(x[i]) * 0.5
            x[i, d // 3] = 1.7e38
        elif case == "all_subnormal":
            x[i] = 1e-40
        else:
            # 2e-36 (a normal scale at bits 8) with its odd elements
            # 5e-39 at u = 0.9: they get level 0, read as 0
            x[i] = 2e-36
            x[i, 1::2] = 5e-39
            u[i] = 0.9
    return x, u


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,path", [
    (1, 1, "registers"), (20, 9, "registers"), (257, 4099, "registers"),
    (20, 47571, "registers"), (100, 47571, "registers"),
    (8, 65536, "registers"), (3, 65537, "global"), (7, 70000, "global"),
    (7, 600000, "global")])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_kernels_match_plain_bitwise(m, d, path, bits):
    """Every epilogue of the row pass (absmax, encode, roundtrip) on its
    register and re-read paths, and the stream (quantize with absmax
    given, dequantize), bitwise against kernels/ref.py on every row: zero,
    NaN-coordinate, ±inf, denormal and all-NaN rows among random ones, m
    up to 257 (clusters queue).  One launch per ops call; a second call
    gives the same bits."""
    _require_cuda()
    from repro_torch.kernels.quantize import qsgd_quantize_cuda, row_path
    assert row_path(d) == path
    gen = torch.Generator(device="cuda").manual_seed(m * d + bits)
    x, u = _qsgd_rows(m, d, gen)
    want_q, want_amax = ref.qsgd_quantize_ref(x, u, bits)
    n0 = dict(ops.LAUNCHES)
    amax = ops.rowwise_absmax(x)
    _same(amax, want_amax)
    q, amax2 = ops.qsgd_quantize(x, u, bits=bits)
    _same(q, want_q)
    _same(amax2, want_amax)
    _same(qsgd_quantize_cuda(x, u, amax, bits), want_q)
    deq = ops.qsgd_dequantize(q, amax2, bits=bits)
    _same(deq, ref.qsgd_dequantize_ref(want_q, want_amax, bits))
    out = ops.qsgd_roundtrip(x, u, bits=bits)
    _same(out, ref.qsgd_roundtrip_ref(x, u, bits))
    torch.cuda.synchronize()
    launched = {k: n - n0[k] for k, n in ops.LAUNCHES.items() if n != n0[k]}
    assert launched == {"rowwise_absmax": 1, "qsgd_quantize": 1,
                        "qsgd_dequantize": 1, "qsgd_roundtrip": 1}
    assert torch.equal(_bits(out), _bits(ops.qsgd_roundtrip(x, u, bits=bits)))
    assert torch.equal(_bits(amax), _bits(ops.rowwise_absmax(x)))
    if m > 1:
        assert bool(torch.all(q[1] == 0)) and float(amax[1, 0]) == 0.0
    if m > 6:
        assert bool(torch.isnan(out[2:7:4]).all())     # NaN rows: all NaN
        assert bool(torch.isnan(out[3:5]).all())       # ±inf rows: all NaN
        assert bool(torch.all(q[2:5] == 0)) and bool(torch.all(q[6] == 0))
    if m > 9:
        # subnormal scalars flushed: these rows cross as zeros
        assert float(amax[9, 0]) == 0.0 and bool(torch.all(out[9] == 0))
        if bits == 8:
            assert bool(torch.all(out[7] == 0))
        if bits == 2:
            assert bool(torch.all(out[8] == 0))
    if m > 10:
        # subnormal elements of a normal row: level 0
        assert bool(torch.all(q[10, 1::2] == 0)) and float(amax[10, 0]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("d,path", [(47571, "registers"), (70000, "global")])
@pytest.mark.parametrize("bits", [2, 3, 8])
def test_qsgd_kernels_subnormal_elements_bitwise(d, path, bits):
    """Rows of normal scale holding subnormal elements, on both paths of
    the row pass and on the stream: every subnormal element gets level 0
    (read as 0, as the reference's run reads it), bitwise the plain
    version.  Row 1 is 2e-36 with its odd elements 5e-39 at u = 0.9 (level
    1 if they were read as they are); row 2 random with every third
    element ±1e-39; row 3 ±[1e-39, 1.1e-38) with one 1.2e-38 at u = 0.95
    (a normal scale at bits 2); row 4 random with subnormals of every
    magnitude."""
    _require_cuda()
    from repro_torch.kernels.quantize import (qsgd_dequantize_cuda,
                                              qsgd_encode_cuda,
                                              qsgd_quantize_cuda,
                                              qsgd_roundtrip_cuda,
                                              row_path, rowwise_absmax_cuda)
    assert row_path(d) == path
    gen = torch.Generator(device="cuda").manual_seed(d + bits)
    x = torch.randn((6, d), generator=gen, device="cuda") * 3
    u = torch.rand((6, d), generator=gen, device="cuda")
    sign = torch.sign(x)
    x[1] = 2e-36
    x[1, 1::2] = 5e-39
    u[1] = 0.9
    x[2, ::3] = sign[2, ::3] * 1e-39
    x[3] = sign[3] * (1e-39 + 1e-38 * torch.rand(d, generator=gen,
                                                 device="cuda"))
    x[3, 17] = 1.2e-38
    u[3] = 0.95
    x[4, 1::2] = sign[4, 1::2] * torch.exp(
        torch.rand(d // 2, generator=gen, device="cuda") * -10 - 89)
    sub = x.abs() < ref.FLT_MIN
    assert bool(sub[1:5].any(dim=1).all()) and not bool(sub[[0, 5]].any())
    want_q, want_amax = ref.qsgd_quantize_ref(x, u, bits)
    assert bool(torch.all(want_q[sub] == 0))
    _same(rowwise_absmax_cuda(x), want_amax)
    q, amax = qsgd_encode_cuda(x, u, bits)
    _same(q, want_q)
    _same(amax, want_amax)
    _same(qsgd_quantize_cuda(x, u, want_amax, bits), want_q)
    _same(qsgd_dequantize_cuda(q, amax, bits),
          ref.qsgd_dequantize_ref(want_q, want_amax, bits))
    _same(qsgd_roundtrip_cuda(x, u, bits), ref.qsgd_roundtrip_ref(x, u, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,offset", [
    (20, 47571, 0), (20, 47571, 1), (5, 1001, 0), (3, 4099, 2),
    (4, 4, 3), (6, 3, 0), (9, 1, 0), (257, 13, 0)])
@pytest.mark.parametrize("bits", [2, 8])
def test_qsgd_stream_odd_and_misaligned(m, d, offset, bits):
    """The stream on odd D (4-vectors straddle rows), D < 4 and arrays
    that start ``offset`` elements into a larger buffer (misaligned: the
    scalar path), bitwise against kernels/ref.py, special rows included."""
    _require_cuda()
    from repro_torch.kernels.quantize import (qsgd_dequantize_cuda,
                                              qsgd_quantize_cuda)
    gen = torch.Generator(device="cuda").manual_seed(m + d + offset)
    x0, u0 = _qsgd_rows(m, d, gen)

    def shifted(t):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device="cuda")
        view = buf[offset:offset + t.numel()].view(t.shape)
        view.copy_(t)
        return view
    x, u = shifted(x0), shifted(u0)
    amax = shifted(ref.rowwise_absmax_ref(x0))
    want_q = ref.qsgd_quantize_ref(x0, u0, bits, absmax=amax)[0]
    q = qsgd_quantize_cuda(x, u, amax, bits)
    _same(q, want_q)
    _same(qsgd_dequantize_cuda(shifted(q), amax, bits),
          ref.qsgd_dequantize_ref(want_q, amax, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,path", [
    (20, 47571, "registers"), (5, 1000, "registers"), (1, 47571, "registers"),
    (100, 4099, "registers"), (257, 1000, "registers"), (4, 9, "registers"),
    (2, 6157, "registers"), (2, 70000, "shared"), (3, 300001, "shared"),
    (2, 600000, "global")])
def test_topk_threshold_kernel_matches_plain_bitwise(m, d, path):
    """m from 1 to 257 (more rows than the card has SMs for a cluster
    each), D on each of the kernel's three paths and not a multiple of
    its cluster of 8; a zero row, a NaN row, a row of ties, a denormal
    row, a row holding inf, a row whose midpoints overflow to inf and a
    row of ~1e-37 whose midpoints fall below the normal range (flushed to
    0) among random ones; k = 1, 10, D/10, D − 1, D and D + 1."""
    _require_cuda()
    from repro_torch.kernels.topk_threshold import row_path
    assert row_path(d) == path
    gen = torch.Generator(device="cuda").manual_seed(m + d)
    absx = torch.randn((m, d), generator=gen, device="cuda").abs()
    absx[0] = 0.0
    if m > 2:
        absx[1, d // 2] = float("nan")
        absx[2] = torch.randint(0, 4, (d,), generator=gen,
                                device="cuda").float() * 0.5
    if m > 3:
        absx[3] *= 1e-39                     # denormal magnitudes
    if m > 5:
        absx[4, ::7] = float("inf")
        absx[5] = absx[5].clamp(max=6.0) * 5e37   # midpoints overflow
    if m > 6:
        absx[6] *= 1e-37                     # midpoints subnormal near D
    for k in sorted({1, 10, -(-d // 10), max(1, d - 1), d, d + 1}):
        got = ops.topk_threshold(absx, k=k)
        _same(got, ref.topk_threshold_ref(absx, k))
        ok = ~torch.isnan(absx).any(1)
        if k <= d:
            kth = torch.kthvalue(absx.cpu(), d - k + 1, dim=1,
                                 keepdim=True).values.cuda()
            assert bool(torch.all(got[ok] <= kth[ok]))
            assert bool(torch.all((absx[ok] >= got[ok]).sum(1) >= k))
        else:
            assert bool(torch.all(got == 0))
        if m > 2:
            assert float(got[1, 0]) == 0.0   # a NaN row keeps lo at 0


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(20, 47571), (3, 70000), (2, 600000)])
def test_topk_threshold_kernel_is_bitwise_reproducible(m, d):
    """Integer counts and no atomics: two calls give the same bits, and
    the kernel equals the plain version's multi-level walk."""
    _require_cuda()
    from repro_torch.kernels.topk_threshold import LEVELS, topk_threshold_cuda
    gen = torch.Generator(device="cuda").manual_seed(d)
    absx = torch.randn((m, d), generator=gen, device="cuda").abs()
    k = -(-d // 10)
    first = topk_threshold_cuda(absx, k)
    assert torch.equal(first, topk_threshold_cuda(absx, k))
    _same(first, ref.topk_threshold_tree_ref(absx, k, LEVELS))


@pytest.mark.gpu
def test_channel_kernels_propagate_nan_and_refuse_bad_args():
    _require_cuda()
    from repro_torch.kernels.quantize import qsgd_quantize_cuda
    x = torch.ones((3, 5000), device="cuda")
    x[1, 4321] = float("nan")
    u = torch.full_like(x, 0.5)
    amax = ops.rowwise_absmax(x)
    _same(amax, ref.rowwise_absmax_ref(x))
    assert torch.isnan(amax[1, 0]) and float(amax[0, 0]) == 1.0
    out = ops.qsgd_roundtrip(x, u, bits=8)
    assert bool(torch.isnan(out[1]).all())
    assert bool(torch.isfinite(out[0]).all())
    _same(out, ref.qsgd_roundtrip_ref(x, u, 8))
    q, _ = ops.qsgd_quantize(x, u, bits=8)
    assert bool(torch.all(q[1] == 0))              # NaN levels convert to 0
    for bits in (1, 9):
        with pytest.raises(ValueError, match="bits"):
            ops.qsgd_quantize(x, u, bits=bits)
        with pytest.raises(ValueError, match="bits"):
            ops.qsgd_roundtrip(x, u, bits=bits)
    with pytest.raises(ValueError):
        ops.qsgd_roundtrip(x, u[:, :10], bits=4)      # noise shape
    with pytest.raises(ValueError):
        ops.qsgd_quantize(x, u.double(), bits=4)      # noise dtype
    with pytest.raises(ValueError):
        ops.rowwise_absmax(x.double())
    with pytest.raises(ValueError):
        ops.rowwise_absmax(x.T)                       # not contiguous
    with pytest.raises(ValueError):
        qsgd_quantize_cuda(x, u[:, :10], amax, 4)     # noise shape
    with pytest.raises(ValueError):
        qsgd_quantize_cuda(x, u, amax.T, 4)           # absmax shape
    with pytest.raises(ValueError):
        ops.qsgd_dequantize(torch.ones((3, 5), device="cuda"), amax, bits=4)
    with pytest.raises(ValueError, match="k must be"):
        ops.topk_threshold(x.abs(), k=0)
    with pytest.raises(ValueError):
        ops.topk_threshold(x.abs().half(), k=3)
    with pytest.raises(ValueError):
        ops.topk_threshold(x.abs().T, k=3)


# ---------------------------------------------------------------------------
# flash attention: the kernel against its plain version at the serving
# path's shapes (gemma2-27b: B 2, H 32, Kh 16, hd 128, prompt 4,608, window
# 4,096, softcap 50), in the model's strided layouts; tolerances are
# tests/test_kernels.py's (f32 2e-5, bf16 3e-2)

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the scaled logits q·k/√hd: N(0, 0.25²), far inside the softcaps (30,
# 50), or N(0, 50²), where cap·tanh(x/cap) saturates and a kernel that
# dropped or misscaled the softcap gives another softmax
LOGIT_STD, CAP_LOGIT_STD = 0.25, 50.0


def _qkv(gen, b, h, kh, sq, sk, hd, dtype, cache_len=None,
         logit_std=LOGIT_STD):
    """q as the model hands it over, (B, Sq, H, hd) transposed; k, v the
    first Sk slots of a (B, C, Kh, hd) cache, transposed.  q and k have
    variance ``logit_std``: the scaled logits have that deviation."""
    c = sk if cache_len is None else cache_len
    a = logit_std ** 0.5
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda") * a
    k = torch.randn((b, c, kh, hd), generator=gen, device="cuda") * a
    v = torch.randn((b, c, kh, hd), generator=gen, device="cuda")
    return (q.to(dtype).transpose(1, 2), k[:, :sk].to(dtype).transpose(1, 2),
            v[:, :sk].to(dtype).transpose(1, 2))


def _row_rel_err(got, want) -> float:
    """max over output rows of |got - want| / |want| (2-norms)."""
    g, w = got.float(), want.float()
    return float((torch.linalg.vector_norm(g - w, dim=-1) /
                  torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-30)).max())


def _flash_close(got, want):
    """Elementwise at FLASH_TOL, and each output row within the same
    tolerance relative to its norm (rows of a near-uniform softmax have
    entries below the atol, which alone would pass them)."""
    tol = FLASH_TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _row_rel_err(got, want) <= tol


def _flash_check(q, k, v, **kw):
    """One launch, counted under the kernel `flash_route` names; returns
    the plain version's result."""
    n0 = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    counter = ops.FLASH_COUNTERS[flash_route(q.dtype, q.shape[2],
                                             q.shape[3])]
    assert {c: n - n0[c] for c, n in ops.LAUNCHES.items()
            if n != n0[c]} == {counter: 1}
    assert got.shape == q.shape and got.dtype == q.dtype
    want = ref.flash_attention_ref(q, k, v, **kw)
    _flash_close(got, want)
    return want


def _fails_without_softcap(kernel, q, k, v, want, **kw):
    """A planted fault: on logits past the cap, the kernel run without its
    softcap must fail both of `_flash_close`'s tests against the plain
    version with it, or the inputs could not tell a dropped softcap."""
    bad = kernel(q, k, v, **dict(kw, softcap=None)).float()
    w = want.float()
    tol = FLASH_TOL[want.dtype]
    assert not bool(torch.all((bad - w).abs() <= tol + tol * w.abs()))
    assert _row_rel_err(bad, w) > tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["global", "local"])
def test_flash_attention_kernel_lm_prefill(layer, dtype):
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _qkv(gen, 2, 32, 16, 4608, 4608, 128, dtype)
    _flash_check(q, k, v, causal=True, softcap=50.0,
                 window=4096 if layer == "local" else None)


def _decode_check(q, k, v, n_split=None, **kw):
    """Through the op, on the decode route, then the kernel's own wrapper
    at ``n_split``, both against the plain version; returns it."""
    assert flash_route(q.dtype, q.shape[2], q.shape[3]) == "decode"
    want = _flash_check(q, k, v, **kw)
    direct = flash_decode_cuda(q, k, v, n_split=n_split, **kw)
    assert direct.stride() == q.stride()
    _flash_close(direct, want)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_lm_decode(dtype):
    """Both [lm] decode shapes on the split-key decode kernel."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = _qkv(gen, 2, 32, 16, 1, 4609, 128, dtype, cache_len=4640)
    _decode_check(q, k, v, causal=True, softcap=50.0)
    # a wrapped local ring: all 4,096 slots in slot order, window 4,096
    q, k, v = _qkv(gen, 2, 32, 16, 1, 4096, 128, dtype)
    _decode_check(q, k, v, causal=True, window=4096, softcap=50.0)


@pytest.mark.gpu
def test_flash_attention_kernel_lm_decode_capped():
    """The decode shapes on logits past softcap 50 (the decode kernel's
    capped path), with the planted fault."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    for sk, clen, kw in ((4609, 4640, dict(causal=True, softcap=50.0)),
                         (4096, None, dict(causal=True, window=4096,
                                           softcap=50.0))):
        q, k, v = _qkv(gen, 2, 32, 16, 1, sk, 128, torch.bfloat16,
                       cache_len=clen, logit_std=CAP_LOGIT_STD)
        want = _decode_check(q, k, v, **kw)
        _fails_without_softcap(flash_decode_cuda, q, k, v, want, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 192, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_ragged(hd, group, dtype):
    """Sq 1/3/16 over Sk 1/70/4,609 (Sk < Sq included: causal rows with no
    key are 0), non-causal and causal + window 48 + softcap 30, with the
    default split count and 1, 2 and Sk splits (then every split holds one
    key, and the window masks most of them whole)."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + 3 * group)
    for sq in (1, 3, 16):
        for sk in (1, 70, 4609):
            q, k, v = _qkv(gen, 2, 2 * group, 2, sq, sk, hd, dtype,
                           cache_len=sk + 5)
            for kw in (dict(causal=False),
                       dict(causal=True, window=48, softcap=30.0)):
                for n_split in (None, 1, 2, sk):
                    want = _decode_check(q, k, v, n_split=n_split, **kw)
                if kw["causal"] and sq > sk:
                    assert not bool(want[:, :, :sq - sk].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_is_bitwise_reproducible(dtype):
    """No atomics: two calls on the same inputs give the same bits, at the
    [lm] global decode shape and at a split count that leaves one key a
    split."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = _qkv(gen, 2, 32, 16, 1, 4609, 128, dtype, cache_len=4640)
    kw = dict(causal=True, softcap=50.0)
    assert torch.equal(flash_decode_cuda(q, k, v, **kw),
                       flash_decode_cuda(q, k, v, **kw))
    q, k, v = _qkv(gen, 1, 16, 2, 16, 300, 64, dtype)
    assert torch.equal(flash_decode_cuda(q, k, v, n_split=300, **kw),
                       flash_decode_cuda(q, k, v, n_split=300, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 40, 64, 80, 96, 136, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_ragged(hd, group, dtype):
    """Through the op (each shape on its route), and the CUDA-core kernel
    itself at every shape; head_dims that fill none of its 64/128/256
    instances, Sq 1, 17 and 129 (one row past a 64- or 128-row tile),
    windows that skip whole key tiles; causal (80, 64) and (96, 40) have
    rows with no key."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd * group)
    for sq, sk in ((37, 101), (1, 70), (130, 130), (80, 64), (96, 40),
                   (17, 300), (129, 1000)):
        q, k, v = _qkv(gen, 2, 2 * group, 2, sq, sk, hd, dtype)
        for kw in (dict(causal=False),
                   dict(causal=True, window=48, softcap=30.0),
                   dict(causal=True),
                   dict(causal=False, window=100)):
            want = _flash_check(q, k, v, **kw)
            _flash_close(flash_attention_cuda(q, k, v, **kw), want)
            if kw["causal"] and sq > sk:
                assert not bool(want[:, :, :sq - sk].any())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [40, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_ragged_capped(hd, dtype):
    """Logits past the softcap at head_dims off the kernel's instances:
    within tolerance with it, and failing the check without it."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + 3)
    for sq, sk in ((37, 101), (129, 1000)):
        q, k, v = _qkv(gen, 2, 4, 2, sq, sk, hd, dtype,
                       logit_std=CAP_LOGIT_STD)
        for kw in (dict(causal=False, softcap=50.0),
                   dict(causal=True, window=48, softcap=30.0)):
            want = _flash_check(q, k, v, **kw)
            _flash_close(flash_attention_cuda(q, k, v, **kw), want)
            _fails_without_softcap(flash_attention_cuda, q, k, v, want, **kw)


def _attention_f64(q, k, v, causal, window=None, softcap=None):
    """Attention computed in float64 throughout (the plain version rounds
    to f32): the yardstick of an f32 kernel's own error."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, kh, h // kh, sq, hd)
    lg = torch.einsum("bkgqh,bksh->bkgqs", qg, k.double()) / hd ** 0.5
    if softcap:
        lg = softcap * torch.tanh(lg / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window:
        valid &= k_pos > q_pos - window
    p = torch.softmax(lg.masked_fill(~valid, -1e300), -1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.double())
    return out.masked_fill(~valid.any(-1)[:, None], 0.0).reshape(b, h, sq, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [40, 128, 136])
def test_flash_attention_kernel_f32_as_accurate_as_plain(hd):
    """Against attention in float64, on capped logits over 1,000 keys (16
    key tiles), the kernel's f32 error stays within twice the plain
    version's own: the online softmax's rescaling must not compound a
    rounding from tile to tile."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + 3)
    q, k, v = _qkv(gen, 2, 4, 2, 129, 1000, hd, torch.float32,
                   logit_std=CAP_LOGIT_STD)
    for kw in (dict(causal=False, softcap=50.0),
               dict(causal=True, window=48, softcap=30.0)):
        exact = _attention_f64(q, k, v, **kw)
        err = float((flash_attention_cuda(q, k, v, **kw).double()
                     - exact).abs().max())
        plain = float((ref.flash_attention_ref(q, k, v, **kw).double()
                       - exact).abs().max())
        assert err <= 2 * plain + 1e-6, (err, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_is_bitwise_reproducible(dtype):
    """No atomics: two calls of the CUDA-core kernel give the same bits,
    at the [lm] global prefill shape (f32 is its route there) and at a
    ragged one."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    kw = dict(causal=True, softcap=50.0)
    q, k, v = _qkv(gen, 2, 32, 16, 4608, 4608, 128, dtype)
    assert torch.equal(flash_attention_cuda(q, k, v, **kw),
                       flash_attention_cuda(q, k, v, **kw))
    q, k, v = _qkv(gen, 1, 16, 2, 129, 300, 136, dtype)
    assert torch.equal(flash_attention_cuda(q, k, v, window=48, **kw),
                       flash_attention_cuda(q, k, v, window=48, **kw))


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take():
    _require_cuda()
    q = torch.randn((1, 4, 8, 64), device="cuda")
    k = torch.randn((1, 2, 8, 64), device="cuda")
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError):              # H % Kh
        ops.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                            k[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError):              # head_dim 36
        ops.flash_attention(q[..., :36].contiguous(),
                            k[..., :36].contiguous(),
                            k[..., :36].contiguous())
    with pytest.raises(ValueError):              # hd not unit stride
        ops.flash_attention(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, window=0)
    # the decode kernel: the same checks, at most 16 queries, n_split >= 1
    qd = q[:, :, :1]
    with pytest.raises(TypeError):
        flash_decode_cuda(qd.half(), k.half(), k.half())
    with pytest.raises(ValueError):              # head_dim 36
        flash_decode_cuda(qd[..., :36].contiguous(), k[..., :36].contiguous(),
                          k[..., :36].contiguous())
    with pytest.raises(ValueError):              # Sq 17
        flash_decode_cuda(torch.randn((1, 4, 17, 64), device="cuda"), k, k)
    with pytest.raises(ValueError):
        flash_decode_cuda(qd, k, k, n_split=0)
    with pytest.raises(ValueError):
        flash_decode_cuda(qd, k, k, softcap=0.0)


# ---------------------------------------------------------------------------
# the tensor-core kernel (csrc/flash_attention_tc.cu): bf16, head_dim 64,
# 80, 128 or 256, which `flash_route` picks for Sq > 16; at bf16's 3e-2


def _tc_check(q, k, v, **kw):
    """Through the op, on the tensor-core route, then the kernel's own
    wrapper, both against the plain version."""
    assert flash_route(q.dtype, q.shape[2], q.shape[3]) == "tc"
    want = _flash_check(q, k, v, **kw)
    direct = flash_attention_tc_cuda(q, k, v, **kw)
    assert direct.stride() == q.stride()
    _flash_close(direct, want)
    return want


TC_MASKS = [dict(causal=False), dict(causal=True),
            dict(causal=True, window=1), dict(causal=True, window=63),
            dict(causal=True, window=63, softcap=30.0),
            dict(causal=True, window=4096, softcap=50.0),
            dict(causal=False, softcap=50.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 192, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("sq,sk", [(37, 101), (77, 77), (130, 130),
                                   (200, 333), (17, 300), (80, 64),
                                   (96, 40)])
def test_flash_attention_tc_ragged(hd, group, sq, sk):
    """Sq and Sk off the 64/128 tiles, Sq < Sk (q aligned to the end of k)
    and Sq > Sk (causal: the first Sq − Sk rows see no key and are 0), q
    transposed from (B, S, H, hd), k and v slices of a longer cache."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + 7 * group + sq)
    q, k, v = _qkv(gen, 2, 2 * group, 2, sq, sk, hd, torch.bfloat16,
                   cache_len=sk + 13)
    for kw in TC_MASKS:
        _tc_check(q, k, v, **kw)


# logits past the cap: every softcap case of TC_MASKS
TC_CAPPED_MASKS = [kw for kw in TC_MASKS if "softcap" in kw] + \
    [dict(causal=True, softcap=50.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 192, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("sq,sk", [(37, 101), (77, 77), (130, 130),
                                   (200, 333), (17, 300), (80, 64),
                                   (96, 40)])
def test_flash_attention_tc_ragged_capped(hd, group, sq, sk):
    """The ragged shapes on logits past the softcap, where the kernel's
    capped instance (tanh, scale / cap, cap · log2 e) is told from the
    uncapped one: each also fails without its softcap."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + 7 * group + sq + 1)
    q, k, v = _qkv(gen, 2, 2 * group, 2, sq, sk, hd, torch.bfloat16,
                   cache_len=sk + 13, logit_std=CAP_LOGIT_STD)
    for kw in TC_CAPPED_MASKS:
        want = _tc_check(q, k, v, **kw)
        _fails_without_softcap(flash_attention_tc_cuda, q, k, v, want, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 192, 256])
def test_flash_attention_tc_contiguous_layout(hd):
    """(B, H, S, hd) contiguous tensors, as well as the model's views."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = (t.contiguous() for t in
               _qkv(gen, 1, 4, 2, 250, 250, hd, torch.bfloat16))
    _tc_check(q, k, v, causal=True, softcap=50.0)
    _tc_check(q, k, v, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(37, 101), (130, 130), (200, 333),
                                   (96, 40)])
def test_flash_attention_tc_mqa(sq, sk):
    """gemma-2b's heads (H 8, one KV head, hd 256): every query head of a
    block's batch row reads the same K/V; both logit scales, the capped
    one with the planted fault."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    for std in (LOGIT_STD, CAP_LOGIT_STD):
        q, k, v = _qkv(gen, 2, 8, 1, sq, sk, 256, torch.bfloat16,
                       cache_len=sk + 13, logit_std=std)
        _tc_check(q, k, v, causal=True)
        _tc_check(q, k, v, causal=True, window=63, softcap=30.0)
        if std == CAP_LOGIT_STD:
            kw = dict(causal=True, softcap=50.0)
            want = _tc_check(q, k, v, **kw)
            _fails_without_softcap(flash_attention_tc_cuda, q, k, v, want,
                                   **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["global", "local"])
def test_flash_attention_tc_lm_prefill(layer):
    """Both [lm] prefill shapes (gemma2-27b: B 2, H 32, Kh 16, S 4,608,
    hd 128, softcap 50; the local layer's window 4,096)."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = _qkv(gen, 2, 32, 16, 4608, 4608, 128, torch.bfloat16)
    _tc_check(q, k, v, causal=True, softcap=50.0,
              window=4096 if layer == "local" else None)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["global", "local"])
def test_flash_attention_tc_lm_prefill_capped(layer):
    """Both [lm] prefill shapes on logits past softcap 50, with the planted
    fault."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, k, v = _qkv(gen, 2, 32, 16, 4608, 4608, 128, torch.bfloat16,
                   logit_std=CAP_LOGIT_STD)
    kw = dict(causal=True, softcap=50.0,
              window=4096 if layer == "local" else None)
    want = _tc_check(q, k, v, **kw)
    _fails_without_softcap(flash_attention_tc_cuda, q, k, v, want, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(1, 4096), (1024, 1024)])
def test_flash_nemotron_shapes(sq, sk):
    """nemotron-4-340b's heads (GQA 96 / 8 of 192, bf16): a prefill of
    1,024 on the tensor-core kernel's (192, 192) instance and a decode
    step over 4,096 keys on the decode kernel, at both logit scales,
    each kernel also failing without the softcap past it."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(sq + 192)
    for std in (LOGIT_STD, CAP_LOGIT_STD):
        q, k, v = _qkv(gen, 1, 96, 8, sq, sk, 192, torch.bfloat16,
                       logit_std=std)
        route = flash_route(q.dtype, sq, 192)
        assert route == ("decode" if sq == 1 else "tc")
        kw = dict(causal=True) if std == LOGIT_STD else \
            dict(causal=True, softcap=50.0)
        want = (_tc_check if route == "tc" else _flash_check)(q, k, v, **kw)
        if "softcap" in kw:
            _fails_without_softcap(ops.FLASH_KERNELS[route][0], q, k, v,
                                   want, **kw)


@pytest.mark.gpu
def test_flash_attention_tc_refuses_what_it_does_not_take():
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _qkv(gen, 1, 4, 2, 40, 40, 128, torch.bfloat16)
    with pytest.raises(TypeError):                 # f32
        flash_attention_tc_cuda(q.float(), k.float(), v.float())
    q, k, v = _qkv(gen, 1, 4, 2, 40, 40, 96, torch.bfloat16)
    with pytest.raises(ValueError):                # head_dim 96
        flash_attention_tc_cuda(q, k, v)
    q, k, v = _qkv(gen, 1, 4, 2, 40, 40, 32, torch.bfloat16)
    with pytest.raises(ValueError):                # head_dim 32
        flash_attention_tc_cuda(q, k, v)
    # the op sends these to the CUDA-core kernel instead
    n0 = ops.LAUNCHES["flash_attention_tc"]
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention_tc"] == n0


# ---------------------------------------------------------------------------
# the fused superstep: captured CUDA graphs of eval-to-eval chunks

SS_FL = dict(rounds=7, local_steps=2, batch_size=16, eval_every=5)


def _ss_fed():
    from repro_torch.data import scenario_label_shift
    return scenario_label_shift(0, n=2000, m=20, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("spec,sampled,codec", [
    ("ucfl_k4", True, "qsgd:8"), ("fedavg", False, None)])
def test_superstep_fused_equals_eventful_on_card(spec, sampled, codec):
    """Full-width LeNet, m = 20, chunks of 1, 5 and 1 rounds (three
    graphs): the fused run's history, clock, comm bits and final params
    and residuals bitwise the eventful run's on the card, with the same
    kernel launch counts; a second fused run replays the cached graphs
    and gives the same bits again."""
    _require_cuda()
    from repro_torch.fl import (Channel, FLConfig, SYSTEMS, UniformFraction,
                                run_federated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fed = _ss_fed()
    kw = dict(fl=FLConfig(**SS_FL), system=SYSTEMS["wireless_slow"],
              sampler=UniformFraction(0.5) if sampled else None,
              channel=None if codec is None else Channel(codec=codec,
                                                         link="tiered:4"),
              keep_state=True, seed=3, device="cuda")
    runs, counts = [], []
    for superstep in (False, None, None):
        n0 = dict(ops.LAUNCHES)
        runs.append(run_federated(spec, fed, superstep=superstep, **kw))
        torch.cuda.synchronize()
        counts.append({k: n - n0[k] for k, n in ops.LAUNCHES.items()})
    ev = runs[0]
    assert counts[0]["mixing_aggregate"] == SS_FL["rounds"]
    for h, c in zip(runs[1:], counts[1:]):
        assert c == counts[0]
        assert (h.rounds, h.mean_acc, h.worst_acc, h.time, h.comm,
                h.comm_bits) == (ev.rounds, ev.mean_acc, ev.worst_acc,
                                 ev.time, ev.comm, ev.comm_bits)
        for k, v in ev.final_params.items():
            assert torch.equal(_bits(h.final_params[k]), _bits(v)), k
        if codec is not None:
            for k, v in ev.final_residual.items():
                assert torch.equal(_bits(h.final_residual[k]), _bits(v)), k


def _ss_chunk_inputs(length):
    """A ucfl_k2 + UniformFraction(0.5) + qsgd:4 round function and one
    chunk's inputs on the card, from the engine's own pieces."""
    from repro_torch.fl import FLConfig, UniformFraction, get_codec
    from repro_torch.fl.draws import TorchDraws, chunk_draws
    from repro_torch.fl.placement import HostVmap
    from repro_torch.fl.simulator import _build_traced_round, init_run
    from repro_torch.fl.strategies import get_strategy
    from repro_torch.models import lenet
    fed = _ss_fed()
    fl = FLConfig(**SS_FL)
    placement, strategy = HostVmap(), get_strategy("ucfl_k2")
    sampler, codec = UniformFraction(0.5), get_codec("qsgd:4")
    draws = TorchDraws(5, "cuda")
    update_fn, stacked, opt_state, (x, y, n), _, state = init_run(
        strategy, fed, fl, None, lenet.loss_fn, lenet.accuracy, placement,
        5, draws, torch.device("cuda"))
    ef = {k: torch.zeros_like(v) for k, v in stacked.items()}
    round_fn = _build_traced_round(strategy, sampler, codec, True,
                                   placement, update_fn, fed.m)
    d = sum(v[0].numel() for v in stacked.values())
    cd = chunk_draws(draws, range(length), step=update_fn, x=x, n=n,
                     sampler=sampler, m=fed.m, noise_d=d, device=x.device)
    eval_fn = lambda st, ed: placement.eval_traced(lenet.accuracy, st, *ed)
    inputs = ((stacked, opt_state, ef), (x, y, n),
              strategy.traced_state(state),
              (cd.slots, cd.mask, cd.noise, cd.faults),
              (fed.x_val, fed.y_val))
    return round_fn, eval_fn, inputs


@pytest.mark.gpu
def test_superstep_replayed_chunk_equals_eager_chunk():
    """A 5-round chunk captured as a CUDA graph: its replay equals the same
    rounds and eval run eagerly, bitwise (carry and scores), twice; the
    counts one replay adds equal the eager chunk's launches."""
    _require_cuda()
    from repro_torch.fl.placement.graphs import (CapturedChunk, StaticInputs,
                                                 draw_row, leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    round_fn, eval_fn, inputs = _ss_chunk_inputs(5)
    carry, data, consts, draws, eval_data = inputs
    n0 = dict(ops.LAUNCHES)
    want = carry
    for i in range(5):
        want, outs = round_fn(want, data, consts, draw_row(draws, i))
        assert outs == (None, None)          # no faults, no defense
    want_accs = eval_fn(want[0], eval_data)
    torch.cuda.synchronize()
    eager = {k: n - n0[k] for k, n in ops.LAUNCHES.items() if n != n0[k]}
    assert eager == {"mixing_aggregate": 5, "qsgd_roundtrip": 5}
    chunk = CapturedChunk(round_fn, eval_fn, 5,
                          StaticInputs(carry, data, consts, eval_data),
                          inputs)
    assert chunk.launches == eager
    for _ in range(2):
        n0 = dict(ops.LAUNCHES)
        got, accs, outs = chunk(*inputs)
        torch.cuda.synchronize()
        assert outs == (None, None)
        assert {k: n - n0[k] for k, n in ops.LAUNCHES.items()
                if n != n0[k]} == eager
        assert torch.equal(accs, want_accs)
        for g, w in zip(leaves(got), leaves(want), strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
def test_superstep_capture_refuses_a_host_sync():
    """A round that reads a value back to the host (a planted ``float()``)
    cannot be captured: building the chunk raises, and the card works on
    afterwards."""
    _require_cuda()
    from repro_torch.fl.placement.graphs import CapturedChunk, StaticInputs
    round_fn, eval_fn, inputs = _ss_chunk_inputs(1)
    carry, data, consts, draws, eval_data = inputs

    def syncing_round(carry, data, consts, draw):
        out = round_fn(carry, data, consts, draw)
        if float(out[0][0]["out_b"].sum()) > 1e30:   # a host sync
            raise AssertionError("unreachable")
        return out

    n0 = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError):
        CapturedChunk(syncing_round, eval_fn, 1,
                      StaticInputs(carry, data, consts, eval_data), inputs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == n0
    assert float((torch.ones(4, device="cuda") * 2).sum()) == 8.0


# ---------------------------------------------------------------------------
# cfl, fedfomo and the fault/defense layer on the card

FAULT_CASES = {
    "fedfomo": ("fedfomo", {}),
    "ucfl_k4_sampler_qsgd8_bitrot_krum": ("ucfl_k4", dict(
        sampled=True, codec="qsgd:8", faults="bitrot:0.3,seed:2",
        robust_agg="krum:0.25")),
    "fedavg_crash_quorum": ("fedavg", dict(faults="crash:0.5",
                                           min_quorum=12)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_faults_fused_equals_eventful_on_card(case):
    """Full-width LeNet, m = 20, chunks of 1, 5 and 1 rounds: the fused
    run's history, clock, comm bits, fault ledger and final params and
    residuals bitwise the eventful run's on the card, twice (the second
    replays the cached graphs).  Launches: the fused round mixes every
    round (the quorum gate is a ``where``), the eventful loop only on
    rounds that met the quorum; every other count equal."""
    _require_cuda()
    from repro_torch.fl import (Channel, FLConfig, SYSTEMS, UniformFraction,
                                run_federated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec, opts = FAULT_CASES[case]
    opts = dict(opts)
    sampled, codec = opts.pop("sampled", False), opts.pop("codec", None)
    fed = _ss_fed()
    kw = dict(fl=FLConfig(**SS_FL), system=SYSTEMS["wireless_slow"],
              sampler=UniformFraction(0.5) if sampled else None,
              channel=None if codec is None else Channel(codec=codec,
                                                         link="tiered:4"),
              keep_state=True, seed=3, device="cuda", **opts)
    runs, counts = [], []
    for superstep in (False, None, None):
        n0 = dict(ops.LAUNCHES)
        runs.append(run_federated(spec, fed, superstep=superstep, **kw))
        torch.cuda.synchronize()
        counts.append({k: n - n0[k] for k, n in ops.LAUNCHES.items()})
    ev = runs[0]
    skipped = ev.extra.get("faults", {}).get("skipped_rounds", 0)
    if "min_quorum" in opts:
        assert 0 < skipped < SS_FL["rounds"]
    assert counts[0]["mixing_aggregate"] == SS_FL["rounds"] - skipped
    for h, c in zip(runs[1:], counts[1:]):
        assert c["mixing_aggregate"] == SS_FL["rounds"]
        assert {k: v for k, v in c.items() if k != "mixing_aggregate"} == \
            {k: v for k, v in counts[0].items() if k != "mixing_aggregate"}
        assert (h.rounds, h.mean_acc, h.worst_acc, h.time, h.comm,
                h.comm_bits) == (ev.rounds, ev.mean_acc, ev.worst_acc,
                                 ev.time, ev.comm, ev.comm_bits)
        assert h.extra.get("faults") == ev.extra.get("faults")
        for k, v in ev.final_params.items():
            assert torch.equal(_bits(h.final_params[k]), _bits(v)), k
        if codec is not None:
            for k, v in ev.final_residual.items():
                assert torch.equal(_bits(h.final_residual[k]), _bits(v)), k


@pytest.mark.gpu
def test_superstep_capture_refuses_a_host_sync_in_the_defense():
    """A robust aggregator that reads a value back to the host cannot be
    captured: the fused run raises (nothing falls back to an eager run),
    the eventful run of the same configuration runs, and the card works
    on afterwards."""
    _require_cuda()
    from repro_torch.fl import FLConfig, run_federated
    from repro_torch.fl.faults.defense import Clip

    class SyncingClip(Clip):
        def transform(self, delta, keep):
            if float(delta.abs().max()) < 0:         # a host sync
                raise AssertionError("unreachable")
            return super().transform(delta, keep)

    fed = _ss_fed()
    kw = dict(fl=FLConfig(**SS_FL), faults="crash:0.2", seed=3,
              device="cuda")
    with pytest.raises(RuntimeError):
        run_federated("fedavg", fed, robust_agg=SyncingClip(1.0),
                      superstep=True, **kw)
    torch.cuda.synchronize()
    h = run_federated("fedavg", fed, robust_agg=SyncingClip(1.0),
                      superstep=False, **kw)
    assert len(h.mean_acc) == len(h.rounds) > 0
    assert float((torch.ones(4, device="cuda") * 2).sum()) == 8.0


# ---------------------------------------------------------------------------
# the buffered-async runtime and the checkpoint format on the card


@pytest.mark.gpu
def test_async_lockstep_equals_sync_on_card():
    """ucfl_k4 at m = 20, full-width LeNet, inv_mu = 0 and K = m: the
    async run's history and final params bitwise the (fused) sync run's,
    the clock equal, one mix an event and one Gram."""
    _require_cuda()
    from repro_torch.fl import AsyncConfig, FLConfig, SYSTEMS, run_federated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fed = _ss_fed()
    kw = dict(fl=FLConfig(**SS_FL), system=SYSTEMS["wired"],
              keep_state=True, seed=3, device="cuda")
    sync = run_federated("ucfl_k4", fed, **kw)
    n0 = dict(ops.LAUNCHES)
    a = run_federated("ucfl_k4", fed, async_cfg=AsyncConfig(buffer_k=fed.m),
                      **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mixing_aggregate"] - n0["mixing_aggregate"] == \
        SS_FL["rounds"]
    assert ops.LAUNCHES["gram_matrix"] - n0["gram_matrix"] == 1
    assert (a.rounds, a.mean_acc, a.worst_acc, a.comm) == \
        (sync.rounds, sync.mean_acc, sync.worst_acc, sync.comm)
    assert a.time == pytest.approx(sync.time, rel=1e-12)
    for k, v in sync.final_params.items():
        assert torch.equal(_bits(a.final_params[k]), _bits(v)), k


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 10, 1])
def test_async_cohort_update_matches_masked_full_update_on_card(k):
    """`HostVmap.update_cohort` (gather k of m = 20 rows, update, scatter)
    against the run-every-row-and-mask default on the card, at `[main]`'s
    shapes (n = 10,000, batch 64): bitwise, params and optimizer state,
    for the cohorts `chip_smoke.py` `[async]` runs (k = 5 and 10).  At
    k = 1 cuBLAS picks another kernel for the vmapped convs' batched
    GEMM (a batch of 1 is not the first row of a batch of 20, bitwise;
    measured on an H100: the two paths then differ by at most 2.6e-7),
    so it is held at f32's rtol 1e-5 / atol 1e-6."""
    _require_cuda()
    from repro_torch.data import scenario_label_shift
    from repro_torch.fl import FLConfig, HostVmap, Placement, TorchDraws
    from repro_torch.fl.simulator import default_model_init
    from repro_torch.models import lenet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fed = scenario_label_shift(0, n=10000, m=20, device="cuda")
    fl = FLConfig(local_steps=2, batch_size=64)
    p = HostVmap()
    _, update = p.build_update(lenet.loss_fn, fl)
    gen = torch.Generator(device="cuda").manual_seed(2)
    stacked = p.stack(default_model_init(fed)(gen), fed.m)
    stacked = {k: v + 0.01 * torch.randn(v.shape, generator=gen,
                                         device="cuda")
               for k, v in stacked.items()}
    opt_state = p.init_opt(p.build_update(lenet.loss_fn, fl)[0], stacked)
    batch = TorchDraws(4, "cuda").batch_indices(
        0, fed.n, fed.x.shape[1], fl.batch_size, fl.local_steps)
    idx = torch.tensor([7, 0, 19, 3, 11, 2, 5, 8, 13, 16][:k],
                       device="cuda")
    keep = torch.ones(k, dtype=torch.bool, device="cuda")
    keep[k // 2] = k == 1            # one row not kept, but for k = 1
    args = (update, idx, keep, stacked, opt_state, fed.x, fed.y, fed.n,
            batch)
    fast = p.update_cohort(*args)
    slow = Placement.update_cohort(p, *args)
    torch.cuda.synchronize()
    pairs = [(fast[0][n], v) for n, v in slow[0].items()]
    pairs += [(fast[1]["mu"][n], v) for n, v in slow[1]["mu"].items()]
    for a, b in pairs:
        if k == 1:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(fast[1]["step"], slow[1]["step"])


@pytest.mark.gpu
def test_async_buffered_qsgd_run_on_card_matches_cpu():
    """A buffered ucfl_k4 + qsgd:8 run (K = 3 of m = 6, max_staleness 2)
    on the card against the same run on the CPU (same init, same draws,
    the CPU on one intra-op thread): clock, comm, comm bits and
    ``extra["async"]`` equal, accuracies within two argmax flips, final
    params within `[agree]`'s rtol 1e-3 / atol 1e-4 but for QSGD level
    flips: a last-bit difference in the local update moves an element's
    stochastic-rounding floor by one level (absmax/127, ~4e-4 here) now
    and then, and the mix spreads it.  So at most 0.1 % of the elements
    may lie outside, none by more than 1e-3 (two such levels; measured
    on an H100: 38 of 285,426, at most 4.2e-4; the same run without the
    channel has none outside, at most 8.9e-8)."""
    _require_cuda()
    from repro_torch.data import FederatedData, scenario_label_shift
    from repro_torch.fl import (AsyncConfig, Channel, FLConfig, SYSTEMS,
                                TorchDraws, run_federated)
    from repro_torch.models import lenet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
            runs[dev] = run_federated(
                "ucfl_k4", fed,
                fl=FLConfig(rounds=4, local_steps=3, batch_size=16,
                            eval_every=1),
                system=SYSTEMS["wireless_slow"],
                async_cfg=AsyncConfig(buffer_k=3, max_staleness=2),
                channel=Channel(codec="qsgd:8", link="tiered:4"),
                model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
                draws=TorchDraws(11, "cpu"), keep_state=True, device=dev)
    finally:
        torch.set_num_threads(threads)
    a, b = runs["cpu"], runs["cuda"]
    assert (a.time, a.comm, a.comm_bits, a.extra["async"]) == \
        (b.time, b.comm, b.comm_bits, b.extra["async"])
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    for x, y in zip(a.mean_acc + a.worst_acc, b.mean_acc + b.worst_acc):
        assert abs(x - y) <= 2 * flip + 1e-6
    outside = total = 0
    for k, v in a.final_params.items():
        d = (b.final_params[k].cpu() - v).abs()
        outside += int((d > 1e-4 + 1e-3 * v.abs()).sum())
        total += v.numel()
        assert float(d.max()) <= 1e-3, k
    assert outside <= total // 1000, (outside, total)


@pytest.mark.gpu
def test_checkpoint_of_cuda_tensors_restores_bitwise(tmp_path):
    """f32 (NaN, -0.0 and a subnormal included), bf16, int32, int64 and
    bool tensors on the card, nested, saved and restored onto the card
    and onto the CPU bit for bit."""
    _require_cuda()
    from repro_torch.checkpoint import restore, save
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.randn((33, 17), generator=gen, device="cuda")
    f32[0, :3] = torch.tensor([float("nan"), -0.0, 1e-40], device="cuda")
    tree = {"f32": f32, "bf16": f32.to(torch.bfloat16),
            "i32": torch.arange(-5, 5, device="cuda", dtype=torch.int32),
            "i64": torch.tensor([2**40, -1], device="cuda"),
            "mask": f32 > 0, "t": f32.T,
            "nested": [{"w": f32[:2], "none": None}, "tag", 3]}
    path = str(tmp_path / "c.msgpack")
    save(path, tree)
    for dev in ("cuda", "cpu"):
        got = restore(path, device=dev)
        for k in ("f32", "bf16", "i32", "i64", "mask", "t"):
            want = tree[k].contiguous().cpu()
            g = got[k]
            assert g.device.type == dev and g.dtype == want.dtype, k
            assert torch.equal(g.cpu().view(torch.uint8),
                               want.view(torch.uint8)), k
        assert torch.equal(got["nested"][0]["w"].cpu().view(torch.int32),
                           f32[:2].cpu().view(torch.int32))
        assert got["nested"][0]["none"] is None
        assert got["nested"][1:] == ["tag", 3]


# ---------------------------------------------------------------------------
# the serving plane: stores built on the card against the CPU's, serving


def _serve_stack(m=8, seed=0):
    """A full-width LeNet-5 population on the CPU: m users in 3 streams,
    each its stream's model plus its own noise, and elements planted so
    the identity store needs its fixup; with the coarse assignment,
    injected qsgd noise and one request per user."""
    from repro_torch.models import lenet
    gen = torch.Generator().manual_seed(seed)
    p0 = lenet.init_params(gen, lenet.LeNetConfig(), device="cpu")
    asn = torch.arange(m) % 3
    stack = {}
    for k, v in p0.items():
        sd = float(v.std()) if v.numel() > 1 and float(v.std()) > 0 else 0.05
        grp = 0.1 * sd * torch.randn((3,) + v.shape, generator=gen)
        own = 0.01 * sd * torch.randn((m,) + v.shape, generator=gen)
        stack[k] = v[None] + grp[asn] + own
    stack["fc1_w"][2, 0, 0], stack["fc1_w"][5, 0, 0] = 1.0, 1e-9
    d = sum(v[0].numel() for v in stack.values())
    noise = torch.rand((m, d), generator=gen)
    xs = torch.randn((m, 28, 28, 1), generator=gen)
    return stack, asn.numpy(), noise, xs


def _apply_one(params, x):
    from repro_torch.models import lenet
    return lenet.apply(params, x[None])[0]


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["identity", "qsgd:4", "topk:0.25"])
def test_store_built_on_card_equals_cpu_store(codec):
    """The refinement, the fixup, the QSGD row pass's levels and absmax
    (one launch) and top-k's stable sort give the CPU's store bitwise;
    the card's full decode (one QSGD stream launch) its reconstruction."""
    _require_cuda()
    from repro_torch.fl import DeltaStore
    stack, asn, noise, _ = _serve_stack()
    cpu = DeltaStore.build(stack, assignment=asn, codec=codec, noise=noise,
                           device="cpu")
    n0 = dict(ops.LAUNCHES)
    gpu = DeltaStore.build(stack, assignment=asn, codec=codec, noise=noise,
                           device="cuda")
    if codec == "qsgd:4":
        assert ops.LAUNCHES["qsgd_quantize"] == n0["qsgd_quantize"] + 1
        assert ops.LAUNCHES["qsgd_dequantize"] == n0["qsgd_dequantize"] + 1
    pairs = [(gpu.base_flat, cpu.base_flat),
             (gpu.fix_values, cpu.fix_values),
             (gpu.fix_indices, cpu.fix_indices),
             (gpu.params_flat(), cpu.params_flat())]
    pairs += [(gpu.payload[k], cpu.payload[k]) for k in cpu.payload]
    for a, b in pairs:
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    assert (gpu.assignment == cpu.assignment).all()
    assert (gpu.recon_err == cpu.recon_err).all()
    assert (gpu.bits.delta_bits == cpu.bits.delta_bits).all()
    if codec == "identity":
        assert gpu.fix_values.shape[1] >= 1 and gpu.recon_err.max() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["identity", "qsgd:4", "topk:0.25"])
def test_serve_engine_on_card_matches_cpu(codec):
    """Served logits on the card against the CPU engine's at `[agree]`'s
    rtol 1e-3 / atol 1e-4 (the forward's f32 GEMMs sum in another
    order), equal argmax, and the parity anchor on the card."""
    _require_cuda()
    from repro_torch.fl import DeltaStore, ServeEngine, check_parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stack, asn, noise, xs = _serve_stack()
    users = [3, 0, 7, 5, 1, 1]
    outs = {}
    for dev in ("cpu", "cuda"):
        store = DeltaStore.build(stack, assignment=asn, codec=codec,
                                 noise=noise, device=dev)
        eng = ServeEngine(store, _apply_one, max_batch=4)
        outs[dev] = eng.serve(users, xs[users]).cpu()
        if dev == "cuda":
            n0 = ops.LAUNCHES["qsgd_dequantize"]
            check_parity(eng, users, xs[users])
            if codec == "qsgd:4":    # the served batch's and the full decode
                assert ops.LAUNCHES["qsgd_dequantize"] == n0 + 2
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(outs["cuda"].argmax(1), outs["cpu"].argmax(1))


@pytest.mark.gpu
def test_microbatcher_contract_on_card():
    """Each request served in a flushed batch (of 4 and of 3) against the
    same request served alone and in a batch of 2, on the card.  Not
    bitwise against batch 1: there the vmapped matmuls of the forward
    (the im2col convs and the FC layers) run cuBLAS's unbatched GEMM,
    which sums in another order than the batched GEMM of batch counts 2
    and up (on an H100 the logits here differ by 3e-7; `chip_smoke.py`
    `[serve]` prints the difference at its config, one ulp of its
    largest logit, also between batches of 2 and 16).  So a request
    alone agrees within the parity anchor's rtol 1e-5 of the batch's max
    |logit|, and here, in a batch of 2, bitwise."""
    _require_cuda()
    from repro_torch.fl import DeltaStore, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    stack, asn, noise, xs = _serve_stack()
    store = DeltaStore.build(stack, assignment=asn, codec="qsgd:4",
                             noise=noise, device="cuda")
    eng = ServeEngine(store, _apply_one, max_batch=4)
    users = [2, 0, 3, 1, 2, 6, 7]
    for u in users:
        eng.submit(u, xs[u].cuda())
    outs = eng.flush()
    assert eng.last_stats["batches"] == 2
    for i, u in enumerate(users):
        one = eng.serve([u], xs[u][None]).cpu().numpy()[0]
        tol = 1e-5 * max(abs(o).max() for o in outs)
        assert abs(outs[i] - one).max() <= tol, (i, abs(outs[i] - one).max())
        v = (u + 1) % len(xs)
        two = eng.serve([u, v], xs[[u, v]]).cpu().numpy()[0]
        assert (outs[i] == two).all(), (i, abs(outs[i] - two).max())


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["identity", "qsgd:4", "topk:0.25"])
def test_store_saved_from_card_restores_bitwise(tmp_path, codec):
    _require_cuda()
    from repro_torch.fl import DeltaStore
    stack, asn, noise, _ = _serve_stack()
    store = DeltaStore.build(stack, assignment=asn, codec=codec,
                             noise=noise, device="cuda")
    path = str(tmp_path / "store.msgpack")
    store.save(path)
    for dev in ("cuda", "cpu"):
        back = DeltaStore.load(path, device=dev)
        assert back.codec.spec == store.codec.spec
        assert (back.assignment == store.assignment).all()
        assert (back.recon_err == store.recon_err).all()
        assert back.bits.total_bytes == store.bits.total_bytes
        for k in store.payload:
            assert torch.equal(back.payload[k].cpu().view(torch.uint8),
                               store.payload[k].cpu().view(torch.uint8))
        assert torch.equal(back.params_flat().cpu().view(torch.int32),
                           store.params_flat().cpu().view(torch.int32))


# ---------------------------------------------------------------------------
# cohort paging on the card: the population on the host, a cohort of 20
# through the resident engine's captured chunks

PG_FL = dict(rounds=4, local_steps=2, batch_size=16, eval_every=1)


def _pg_fed(m=80):
    """A full-width LeNet population of ``m`` clients, on the host."""
    from repro_torch.data import FederatedData, scenario_label_shift
    fed = scenario_label_shift(0, n=100 * m, m=m, device="cuda")
    return FederatedData(*(t.cpu() for t in fed))


def _pg_kw(fed, codec="qsgd:4", **kw):
    from repro_torch.fl import Channel, FLConfig, SYSTEMS
    from repro_torch.fl.simulator import default_model_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dict(fl=FLConfig(**{**PG_FL, **kw}),
                system=SYSTEMS["wireless_slow"],
                channel=None if codec is None else Channel(codec=codec),
                model_init=default_model_init(fed), keep_state=True, seed=3,
                device="cuda")


def _pg_rows(tree, idx):
    if isinstance(tree, dict):
        return {k: _pg_rows(v, idx) for k, v in tree.items()}
    return None if tree is None else tree[torch.as_tensor(idx)]


def _pg_same(a, b, rows=None):
    """Histories equal; final params, optimizer state and residuals (``a``'s
    rows ``rows`` when given) bitwise, wherever they live."""
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)

    def same(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                same(x[k], y[k])
            return
        assert (x is None) == (y is None)
        if x is not None:
            x, y = x.cpu(), y.cpu()
            assert x.dtype == y.dtype
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))

    for part in ("final_params", "final_opt_state", "final_residual"):
        x = getattr(a, part)
        same(x if rows is None else _pg_rows(x, rows), getattr(b, part))


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "qsgd:4"])
def test_paged_fixed_cohort_is_resident_on_card(codec):
    """A paged `FixedCohort` of 20 rows of an 80-client host population:
    history and rows bitwise the resident fused run (CUDA graphs) on the
    sub-population on the card, with the same launches."""
    _require_cuda()
    from repro_torch.data import FederatedData
    from repro_torch.fl import (FixedCohort, PagingConfig, run_federated,
                                sub_federated)
    fed = _pg_fed()
    idx = np.arange(20) * 4
    kw = _pg_kw(fed, codec)
    n0 = dict(ops.LAUNCHES)
    pag = run_federated("ucfl_k4", fed, **kw,
                        paging=PagingConfig(schedule=FixedCohort(idx)))
    torch.cuda.synchronize()
    n1 = dict(ops.LAUNCHES)
    sub = FederatedData(*(t.cuda() for t in sub_federated(fed, idx)))
    res = run_federated("ucfl_k4", sub, superstep=True, **kw)
    torch.cuda.synchronize()
    assert ({k: n1[k] - n0[k] for k in n0}
            == {k: ops.LAUNCHES[k] - n1[k] for k in n0})
    assert n1["mixing_aggregate"] - n0["mixing_aggregate"] == PG_FL["rounds"]
    _pg_same(pag, res, rows=idx)
    assert pag.final_params["conv1_w"].device.type == "cpu"


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["sweep", "random"])
def test_paged_prefetch_on_equals_off_on_card(schedule):
    """Prefetch on and off bitwise on the card: a disjoint sweep (80
    clients, cohorts of 20) and random cohorts of 20 out of 30, where
    every step overlaps the last (the drain-before-gather path)."""
    _require_cuda()
    from repro_torch.fl import PagingConfig, RandomCohorts, run_federated
    fed = _pg_fed()
    if schedule == "random":
        from repro_torch.fl import sub_federated
        fed = sub_federated(fed, np.arange(30))
        sched = RandomCohorts(20, seed=1)
        assert all(np.intersect1d(sched.indices(t, 30),
                                  sched.indices(t + 1, 30)).size
                   for t in range(PG_FL["rounds"] - 1))
    else:
        sched = "sweep"
    kw = _pg_kw(fed)
    on, off = (run_federated("ucfl_k4", fed, **kw, paging=PagingConfig(
        cohort=20, schedule=sched, prefetch=p)) for p in (True, False))
    _pg_same(on, off)


@pytest.mark.gpu
def test_paged_peak_memory_is_the_same_each_run():
    """The peak of the bytes a paged sweep's tensors ask for (prefetch
    on, cohorts of 20 over 200 and 240 clients: every step a new cohort
    past the setup cache) is the same in every run and at both sizes:
    the copy legs free each block where the program drops it, not when
    a stream gets past it."""
    import gc
    _require_cuda()
    from repro_torch.fl import PagingConfig, run_federated, sub_federated
    fed = _pg_fed(240)
    kw = {**_pg_kw(fed, "qsgd:8", rounds=12), "keep_state": False}
    run_federated("ucfl_k4", fed, **kw, paging=PagingConfig(cohort=20))
    peaks = []
    for m in (200, 240, 200):
        f = fed if m == fed.m else sub_federated(fed, np.arange(m))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_federated("ucfl_k4", f, **kw, paging=PagingConfig(cohort=20))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.memory_stats()["requested_bytes.all.peak"])
    assert len(set(peaks)) == 1, peaks


@pytest.mark.gpu
def test_paged_pending_rows_survive_the_next_replay(tmp_path):
    """Every store row after a 4-chunk disjoint sweep, with prefetch on
    and off, against the same sweep run one chunk an invocation (resumed
    from its snapshot each time, so no chunk is ever pending while
    another replays): a chunk's rows read from the graph's static
    buffers after the next replay would carry the next cohort's values.
    The four cohorts' rows must also differ from each other."""
    _require_cuda()
    from repro_torch.fl import PagingConfig, run_federated
    fed = _pg_fed()
    kw = _pg_kw(fed)
    ck = dict(cohort=20, checkpoint_dir=str(tmp_path / "ck"))
    for _ in range(PG_FL["rounds"]):
        serial = run_federated("ucfl_k4", fed, **kw, paging=PagingConfig(
            max_chunks=1, resume=True, **ck))
    assert serial.extra["paging"]["resumed_at"] == PG_FL["rounds"] - 1
    for prefetch in (True, False):
        _pg_same(run_federated("ucfl_k4", fed, **kw, paging=PagingConfig(
            cohort=20, prefetch=prefetch)), serial)
    w = serial.final_params["out_w"]
    blocks = [w[20 * c:20 * (c + 1)] for c in range(4)]
    assert all(not torch.equal(blocks[i], blocks[j])
               for i in range(4) for j in range(i + 1, 4))


@pytest.mark.gpu
def test_paged_fetch_snapshot_survives_overwrite():
    """`Placement.fetch` snapshots on the compute stream: writing the
    source in place right after does not reach the host copy."""
    _require_cuda()
    from repro_torch.fl import HostVmap
    src = {"a": torch.arange(1 << 20, device="cuda", dtype=torch.float32)}
    want = src["a"].cpu()
    fetched = HostVmap().fetch(src, torch.device("cuda"))
    src["a"].mul_(-1.0)
    got = fetched.wait()
    assert got["a"].device.type == "cpu" and got["a"].is_pinned()
    assert torch.equal(got["a"], want)


@pytest.mark.gpu
def test_paged_one_captured_chunk_serves_two_populations(tmp_path):
    """Paged sweeps over 40 and then 80 clients of the same padded shapes:
    the second adds no captured chunk and no cache entry; resume with
    `TorchDraws` on the card is bitwise."""
    _require_cuda()
    from repro_torch.fl import PagingConfig, run_federated, sub_federated
    from repro_torch.fl import simulator as sim
    from repro_torch.fl.placement.graphs import CapturedChunk
    fed = _pg_fed()
    kw = _pg_kw(fed)
    run_federated("ucfl_k4", sub_federated(fed, np.arange(40)), **kw,
                  paging=PagingConfig(cohort=20))
    before = {k: dict(v) for k, v in sim._SUPERSTEP_FNS.items()}
    chunks = [c for v in before.values() for c in v.values()
              if isinstance(c, CapturedChunk)]
    assert chunks
    full = run_federated("ucfl_k4", fed, **kw, paging=PagingConfig(cohort=20))
    assert set(sim._SUPERSTEP_FNS) == set(before)
    for key, entry in sim._SUPERSTEP_FNS.items():
        assert entry.keys() == before[key].keys()
        assert all(entry[k] is c for k, c in before[key].items())
    base = dict(cohort=20, store_dir=str(tmp_path / "store"),
                checkpoint_dir=str(tmp_path / "ck"))
    run_federated("ucfl_k4", fed, **kw,
                  paging=PagingConfig(max_chunks=2, **base))
    res = run_federated("ucfl_k4", fed, **kw,
                        paging=PagingConfig(resume=True, **base))
    assert res.extra["paging"]["resumed_at"] == 2
    _pg_same(res, full)


@pytest.mark.gpu
def test_async_paged_lockstep_is_resident_on_card():
    """K = population = 20 on the wired system: the store-backed async
    loop bitwise the resident `run_async` on the card."""
    _require_cuda()
    from repro_torch.data import FederatedData
    from repro_torch.fl import (AsyncConfig, PagingConfig, SYSTEMS,
                                run_async)
    fed = _pg_fed(20)
    kw = dict(_pg_kw(fed), system=SYSTEMS["wired"],
              async_cfg=AsyncConfig(buffer_k=20))
    res = run_async("ucfl_k4", FederatedData(*(t.cuda() for t in fed)), **kw)
    pag = run_async("ucfl_k4", fed, paging=PagingConfig(cohort=20), **kw)
    _pg_same(pag, res)


# ---------------------------------------------------------------------------
# the hierarchical edge tier: device rows through the channel kernels

HI_TWO = dict(devices_per_user="ragged:2-4", edge_codec="qsgd:4",
              edge_link="tiered:4", edge_latency=0.5)


def _hi_run(spec, fed, superstep, **kw):
    from repro_torch.fl import FLConfig, SYSTEMS, run_federated
    n0 = dict(ops.LAUNCHES)
    h = run_federated(spec, fed, fl=FLConfig(**SS_FL), superstep=superstep,
                      system=SYSTEMS["wireless_slow"], keep_state=True,
                      seed=3, device="cuda", **kw)
    torch.cuda.synchronize()
    return h, {k: n - n0[k] for k, n in ops.LAUNCHES.items()}


def _hi_same_history(a, b):
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)


@pytest.mark.gpu
def test_hierarchy_flat_anchor_on_card():
    """``HierarchyConfig(devices_per_user=1)`` with ucfl_k4 on both
    engines: history, clock, comm bits, final params and the launches
    bitwise the flat run's on the card."""
    _require_cuda()
    from repro_torch.fl import HierarchyConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    fed = _ss_fed()
    for superstep in (None, False):
        flat, c0 = _hi_run("ucfl_k4", fed, superstep)
        anc, c1 = _hi_run("ucfl_k4", fed, superstep,
                          hierarchy=HierarchyConfig(devices_per_user=1))
        _hi_same_history(anc, flat)
        assert c1 == c0
        assert anc.extra["hierarchy"]["d_max"] == 1
        for k, v in flat.final_params.items():
            assert torch.equal(_bits(anc.final_params[k]), _bits(v)), k


@pytest.mark.gpu
def test_hierarchy_two_level_fused_equals_eventful_on_card():
    """ucfl_k4 over ``ragged:2-4`` devices with a qsgd:4 edge codec on a
    tiered:4 edge link: the captured rounds bitwise the eventful loop
    (history, edge books, final params and `EdgeState`), with one QSGD
    row pass a round over the (m·d_max, F) device rows on both engines."""
    _require_cuda()
    from repro_torch.fl import HierarchyConfig
    from repro_torch.fl.placement.graphs import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    fed = _ss_fed()
    runs = [_hi_run("ucfl_k4", fed, s, hierarchy=HierarchyConfig(**HI_TWO))
            for s in (None, False, None)]
    (ev, c_ev) = runs[1]
    assert c_ev["qsgd_roundtrip"] == SS_FL["rounds"]
    assert c_ev["mixing_aggregate"] == SS_FL["rounds"]
    for h, c in (runs[0], runs[2]):
        assert c == c_ev
        _hi_same_history(h, ev)
        assert h.extra["hierarchy"] == ev.extra["hierarchy"]
        for k, v in ev.final_params.items():
            assert torch.equal(_bits(h.final_params[k]), _bits(v)), k
        for a, b in zip(leaves(h.final_opt_state), leaves(ev.final_opt_state),
                        strict=True):
            assert torch.equal(a, b)
    assert ev.final_opt_state.edge_ef is not None


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
def test_hierarchy_device_rows_through_the_channel_kernels(bits):
    """The edge crossing's shapes: 20 users of up to 4 devices, (80,
    47,571) device rows, 20 of them padding rows of zeros (invalid device
    slots): the QSGD row pass's roundtrip and the top-k kernel bitwise
    their plain versions, one launch each."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(bits)
    x = torch.randn((80, 47571), generator=gen, device="cuda") * 0.01
    x[60:] = 0.0
    u = torch.rand((80, 47571), generator=gen, device="cuda")
    n0 = dict(ops.LAUNCHES)
    got = ops.qsgd_roundtrip(x, u, bits=bits)
    _same(got, ref.qsgd_roundtrip_ref(x, u, bits))
    a = x.abs()
    thresh = ops.topk_threshold(a, k=4758)
    _same(thresh, ref.topk_threshold_ref(a, 4758))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qsgd_roundtrip"] - n0["qsgd_roundtrip"] == 1
    assert ops.LAUNCHES["topk_threshold"] - n0["topk_threshold"] == 1


# ---------------------------------------------------------------------------
# the mesh placement on a one-rank NCCL group


@pytest.fixture(scope="module", autouse=True)
def _end_process_group():
    """The mesh tests' process group ends with the module."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _nccl_and_gloo():
    """The process's default group (a one-rank NCCL group the mesh starts
    in-process) and a gloo group over the same rank, for the CPU side."""
    import torch.distributed as dist
    from repro_torch.fl import MeshShardMap
    MeshShardMap()
    assert dist.get_backend() == "nccl"
    global _GLOO
    if "_GLOO" not in globals():
        _GLOO = dist.new_group(backend="gloo")
    return _GLOO


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["full", "plan"])
@pytest.mark.parametrize("schedule", ["gspmd", "shard_map_streams",
                                      "shard_map_unicast"])
def test_mesh_schedules_nccl_against_gloo(schedule, kind):
    """Each schedule on the one-rank NCCL group (the mix through the
    Y = W Θ kernel, one launch) against the same schedule over gloo on
    the CPU (the plain version), at f32 1e-5; and bitwise the card's host
    mix."""
    _require_cuda()
    from repro_torch.core import (StreamPlan, mix_schedule, stream_aggregate,
                                  user_centric_aggregate)
    gloo = _nccl_and_gloo()
    gen = torch.Generator(device="cuda").manual_seed(3)
    stack = {"a": torch.randn((20, 6, 1, 5, 5), generator=gen,
                              device="cuda"),
             "b": torch.randn((20, 47571 - 150), generator=gen,
                              device="cuda")}
    w = torch.rand((20, 20), generator=gen, device="cuda")
    w = w / w.sum(1, keepdim=True)
    asn = torch.randint(0, 4, (20,), generator=gen, device="cuda")
    args = (w, None) if kind == "full" else (w[:4], asn)
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = mix_schedule(None, stack, *args, schedule=schedule)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mixing_aggregate"] - n0 == 1
    cpu = mix_schedule(gloo, {k: v.cpu() for k, v in stack.items()},
                       *(None if a is None else a.cpu() for a in args),
                       schedule=schedule)
    host = (user_centric_aggregate(stack, w) if kind == "full" else
            stream_aggregate(stack, StreamPlan(w[:4], asn, None)))
    for k in stack:
        torch.testing.assert_close(got[k].cpu(), cpu[k], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(_bits(got[k]), _bits(host[k])), k


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["gspmd", "shard_map_streams",
                                      "shard_map_unicast"])
def test_mesh_run_on_card_is_the_host_run(schedule):
    """ucfl_k4 + qsgd:8 at full width on the one-rank NCCL mesh: the
    fused run (its collectives captured in the chunk's CUDA graph) and
    the eventful run bitwise the `HostVmap` run on the card, with its
    launches; and the gloo CPU mesh run of a small scenario agrees with
    the card's at [agree]'s tolerances."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data import FederatedData, scenario_label_shift
    from repro_torch.fl import (Channel, FLConfig, MeshShardMap, TorchDraws,
                                run_federated)
    from repro_torch.models import lenet
    gloo = _nccl_and_gloo()
    fed = _ss_fed()
    fl = FLConfig(rounds=4, local_steps=2, batch_size=32, eval_every=2)
    kw = dict(fl=fl, keep_state=True, channel=Channel(codec="qsgd:8"))
    host = run_federated("ucfl_k4", fed, **kw)
    for superstep in (None, False):
        n0 = dict(ops.LAUNCHES)
        h = run_federated("ucfl_k4", fed, superstep=superstep,
                          placement=MeshShardMap(schedule=schedule), **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["mixing_aggregate"] - n0["mixing_aggregate"] \
            == fl.rounds
        assert (h.mean_acc, h.time, h.comm_bits) == (host.mean_acc,
                                                     host.time,
                                                     host.comm_bits)
        for k, v in host.final_params.items():
            assert torch.equal(_bits(h.final_params[k]), _bits(v)), k
    small = scenario_label_shift(3, n=600, m=6, device="cpu")
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    fl2 = FLConfig(rounds=2, local_steps=2, batch_size=16, eval_every=1)
    runs = {}
    for dev, f, pl in (
            ("cpu", small, MeshShardMap(gloo, schedule=schedule,
                                        device="cpu")),
            ("cuda", FederatedData(*(t.cuda() for t in small)),
             MeshShardMap(schedule=schedule))):
        runs[dev] = run_federated(
            "ucfl_k2", f, fl=fl2, placement=pl, keep_state=True,
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), device=dev)
    assert runs["cpu"].comm == runs["cuda"].comm
    for k, v in runs["cpu"].final_params.items():
        torch.testing.assert_close(runs["cuda"].final_params[k].cpu(), v,
                                   rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# federated LM training (launch/train.py) and the scenarios on the card


def _lm_case(m=4):
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import init_model_params
    from repro_torch.launch.train import lm_federated_data, lm_fns
    from repro_torch.models.scan import flat_params
    cfg = get_smoke_config("stablelm-3b")
    fed = lm_federated_data(0, m, pool=8, n_val=4, seq=32,
                            vocab=cfg.vocab_size, device="cpu")
    p0 = flat_params(init_model_params(torch.Generator().manual_seed(1),
                                       cfg))
    return cfg, fed, p0, lm_fns(cfg)


@pytest.mark.gpu
def test_lm_loss_and_grad_on_card_match_cpu():
    """The scanned LM loss and its gradient (`vmap(grad)` over 3 clients,
    as the engine takes it) on the card against the CPU, f32 with TF32
    off, at rtol 1e-4 / atol 1e-6."""
    _require_cuda()
    from torch.func import grad, vmap
    cfg, fed, p0, (loss_fn, _) = _lm_case()
    stacked = {k: v[None].expand((3,) + v.shape).clone()
               for k, v in p0.items()}
    batch = {"x": fed.x[:3, :2]}
    vg = vmap(grad(loss_fn, has_aux=True))
    want, wm = vg(stacked, batch)
    got, gm = vg({k: v.cuda() for k, v in stacked.items()},
                 {"x": batch["x"].cuda()})
    torch.testing.assert_close(gm["loss"].cpu(), wm["loss"], rtol=1e-4,
                               atol=0)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "qsgd:8"])
def test_lm_run_fused_equals_eventful_on_card(codec):
    """ucfl_k2 on LM clients on the card: the fused run (the LM's local
    update captured in a CUDA graph) bitwise the eventful run, one mix a
    round and one Gram a run through the kernels (and a row pass a round
    with qsgd:8)."""
    _require_cuda()
    from repro_torch.fl import Channel, FLConfig, run_federated
    from repro_torch.data import FederatedData
    cfg, fed, p0, (loss_fn, acc_fn) = _lm_case()
    fed = FederatedData(*(t.cuda() for t in fed))
    fl = FLConfig(rounds=3, local_steps=2, batch_size=2, eval_every=2,
                  opt_state_dtype="param")
    kw = dict(fl=fl, keep_state=True, loss_fn=loss_fn, acc_fn=acc_fn,
              model_init=lambda gen: {k: v.cuda() for k, v in p0.items()},
              channel=None if codec is None else Channel(codec=codec))
    runs = []
    for superstep in (None, False):
        n0 = dict(ops.LAUNCHES)
        h = run_federated("ucfl_k2", fed, superstep=superstep, **kw)
        torch.cuda.synchronize()
        got = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
        assert got["mixing_aggregate"] == 3 and got["gram_matrix"] == 1
        assert got["qsgd_roundtrip"] == (3 if codec else 0)
        runs.append(h)
    a, b = runs
    assert (a.mean_acc, a.time, a.comm) == (b.mean_acc, b.time, b.comm)
    for k, v in a.final_params.items():
        assert torch.equal(_bits(v), _bits(b.final_params[k])), k


@pytest.mark.gpu
def test_lm_train_cli_on_card_agrees_with_cpu(capsys):
    """`launch.train.main` at cpu-small on the card and on the CPU: the
    same host-drawn data and params, the final CE within rtol 1e-4."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import train
    argv = ["--placement", "host", "--clients", "4", "--steps", "2",
            "--eval-every", "1", "--pool", "8", "--seq", "32", "--batch",
            "2"]
    cpu = train.main(argv + ["--device", "cpu"])
    card = train.main(argv + ["--device", "cuda"])
    assert card == pytest.approx(cpu, rel=1e-4)
    assert "params/model: 2.4M" in capsys.readouterr().out


@pytest.mark.gpu
def test_lm_bf16_leaves_mix_on_card():
    """The mix of an LM's bf16 leaves (more than one launch's worth of
    leaves, the widest 50,304 x 256) against the plain version, and
    bitwise against one-leaf calls."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    widths = [50304 * 256, 7, 2560, 256 * 6912] + [513] * 36
    thetas = [torch.randn((4, d), generator=gen, device="cuda").to(
        torch.bfloat16) for d in widths]
    w = torch.rand((4, 4), generator=gen, device="cuda")
    w = w / w.sum(1, keepdim=True)
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = ops.mixing_aggregate_leaves(w, thetas)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mixing_aggregate"] - n0 == -(-len(thetas) // 32)
    for y, t in zip(got, thetas):
        torch.testing.assert_close(y.float(),
                                   ref.mixing_aggregate_ref(w, t).float(),
                                   rtol=2e-2, atol=2e-2)
        assert torch.equal(y.view(torch.int16),
                           ops.mixing_aggregate(w, t).view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["emnist_label_shift",
                                  "emnist_covariate_shift",
                                  "cifar_concept_shift"])
def test_scenarios_on_card_equal_cpu_on_given_data(name):
    """Each scenario on the card from the same base arrays as on the CPU:
    the same `FederatedData`, bitwise."""
    _require_cuda()
    from repro_torch.data import SCENARIOS, synthetic_cifar, synthetic_emnist
    syn = synthetic_cifar if name.startswith("cifar") else synthetic_emnist
    base = syn(torch.Generator().manual_seed(2), 800)
    kw = dict(n=800, m=8)
    cpu = SCENARIOS[name](data=base, device="cpu", **kw)
    card = SCENARIOS[name](data={k: v.cuda() for k, v in base.items()},
                           device="cuda", **kw)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,sq,sk,hd", [
    (torch.bfloat16, 32, 32, 80),        # 7a, a served prefill
    (torch.bfloat16, 300, 300, 128),     # 7a, ragged tiles
    (torch.bfloat16, 1, 48, 80),         # 7c, a served decode step
    (torch.float32, 1, 4096, 128),       # 7c, one user's split count
    (torch.float32, 40, 40, 64)])        # 7b
def test_vmapped_flash_op_bitwise_per_user_on_card(dtype, sq, sk, hd):
    """`ops.flash_attention` under `torch.func.vmap` (4 users, each a batch
    row with its own keys, as the per-user decode gives them): one launch
    for the batch, bitwise the 4 per-user calls (the decode kernel's
    split count is one user's)."""
    _require_cuda()
    from torch.func import vmap
    gen = torch.Generator(device="cuda").manual_seed(sq + hd)
    u, h, kh = 4, 8, 4
    q = torch.randn((u, 1, sq, h, hd), generator=gen, device="cuda").to(
        dtype).transpose(2, 3)
    k = torch.randn((u, 1, sk, kh, hd), generator=gen, device="cuda").to(
        dtype).transpose(2, 3)
    v = torch.randn_like(k)
    kw = dict(window=None if sq > 1 else 1000, softcap=50.0)
    counter = ops.FLASH_COUNTERS[flash_route(dtype, sq, hd)]
    n0 = ops.LAUNCHES[counter]
    got = vmap(lambda a, b, c: ops.flash_attention(a, b, c, **kw))(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == n0 + 1
    for i in range(u):
        one = ops.flash_attention(q[i], k[i], v[i], **kw)
        assert torch.equal(got[i], one), i


@pytest.mark.gpu
def test_olmoe_decode_on_card_agrees_with_cpu():
    """olmoe's smoke config (4 experts, top 2, qk_norm) through
    `generate` on the card against the CPU: f32, TF32 off, logits within
    1e-4 of each step's and the tokens equal."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("olmoe-1b-7b")
    params = T.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    a = generate(params, cfg, prompt, 6, 64, return_logits=True)
    b = generate(tree_from_numpy(tree_to_numpy(params), "cuda"), cfg,
                 prompt.cuda(), 6, 64, return_logits=True)
    for x, y in zip(a.logits, b.logits):
        torch.testing.assert_close(y.cpu(), x, rtol=1e-4, atol=1e-4)
    assert torch.equal(a.tokens, b.tokens.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_families_decode_on_card_agree_with_cpu(arch):
    """mamba2's and zamba2's smoke configs (the SSD scan at chunk 32 over a
    prompt of 40, zamba2's shared attention block) through `generate` on
    the card against the CPU: f32, TF32 off, logits within 1e-4 of each
    step's, the tokens equal, one flash launch an attention layer a
    step."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    cfg = get_smoke_config(arch)
    params = T.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    a = generate(params, cfg, prompt, 6, 64, return_logits=True)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    with ops.launches_set_aside() as made:
        b = generate(tree_from_numpy(tree_to_numpy(params), "cuda"), cfg,
                     prompt.cuda(), 6, 64, return_logits=True)
    assert sum(made.values()) == 6 * n_attn
    for x, y in zip(a.logits, b.logits):
        torch.testing.assert_close(y.cpu(), x, rtol=1e-4, atol=1e-4)
    assert torch.equal(a.tokens, b.tokens.cpu())


@pytest.mark.gpu
def test_federated_serve_cli_on_card_agrees_with_cpu(capsys):
    """`launch.serve.main --federated` at its smallest flags on the card
    and on the CPU (host-drawn data, params, draws and prompts): the
    same served tokens, the parity anchor on both."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import serve
    argv = ["--federated", "--arch", "stablelm-3b", "--rounds", "1",
            "--clients", "2", "--pool", "5", "--requests", "3", "--tokens",
            "3", "--prompt-len", "8", "--max-batch", "2"]
    cpu = serve.main(argv + ["--device", "cpu"])
    card = serve.main(argv + ["--device", "cuda"])
    for a, b in zip(cpu, card):
        np.testing.assert_array_equal(a, b)
    assert capsys.readouterr().out.count("parity anchor OK") == 2


# ---------------------------------------------------------------------------
# a value head dim dv apart from dk (MLA's naive path), on all three
# kernels: the CUDA-core kernel at any pair, the decode kernel at any
# pair, the tensor-core kernel at (192, 128) in bf16


def _qkv_dv(gen, b, h, kh, sq, sk, dk, dv, dtype, logit_std=LOGIT_STD):
    """As `_qkv` at head dim dk, with v (B, Kh, Sk, dv) the tail of a
    wider (B, C, Kh, 16 + dv) tensor, as MLA's expanded values are the
    tail of ``wkv_b``'s (B, S, H, nope + v) product."""
    q, k, _ = _qkv(gen, b, h, kh, sq, sk, dk, dtype, cache_len=sk + 5,
                   logit_std=logit_std)
    wide = torch.randn((b, sk + 5, kh, 16 + dv), generator=gen,
                       device="cuda").to(dtype)
    return q, k, wide[:, :sk, :, 16:].transpose(1, 2)


def _dv_check(q, k, v, **kw):
    """Through the op (one launch on its route) and on each kernel that
    takes the shape, against the plain version; the output (B, H, Sq,
    dv) in q's layout.  Returns the plain version's result."""
    dk, dv = q.shape[3], v.shape[3]
    route = flash_route(q.dtype, q.shape[2], dk, dv)
    n0 = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {c: n - n0[c] for c, n in ops.LAUNCHES.items()
            if n != n0[c]} == {ops.FLASH_COUNTERS[route]: 1}
    assert got.shape == (*q.shape[:3], dv) and got.dtype == q.dtype
    assert got.transpose(1, 2).is_contiguous()     # q's (B, S, H) order
    want = ref.flash_attention_ref(q, k, v, **kw)
    _flash_close(got, want)
    _flash_close(flash_attention_cuda(q, k, v, **kw), want)
    if route == "decode":
        for ns in (1, 2, k.shape[2]):
            _flash_close(flash_decode_cuda(q, k, v, n_split=ns, **kw), want)
    if route == "tc":
        _flash_close(flash_attention_tc_cuda(q, k, v, **kw), want)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("dk,dv,dtype", [(24, 16, torch.float32),
                                         (24, 16, torch.bfloat16),
                                         (192, 128, torch.bfloat16),
                                         (192, 128, torch.float32),
                                         (32, 48, torch.float32)])
@pytest.mark.parametrize("sq,sk", [(1, 70), (3, 333), (16, 40), (17, 300),
                                   (77, 77), (130, 130), (96, 40)])
def test_flash_kernels_dv_ragged(dk, dv, dtype, sq, sk):
    """Every route at dv != dk on ragged shapes, Kh = H (MLA) and GQA
    group 2, at both logit scales; past the softcap each kernel also
    fails without it."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(dk + dv + sq + sk)
    for h, kh in ((4, 4), (4, 2)):
        q, k, v = _qkv_dv(gen, 2, h, kh, sq, sk, dk, dv, dtype)
        _dv_check(q, k, v, causal=True)
        _dv_check(q, k, v, causal=False)
        _dv_check(q, k, v, causal=True, window=48, softcap=30.0)
        q, k, v = _qkv_dv(gen, 2, h, kh, sq, sk, dk, dv, dtype,
                          logit_std=CAP_LOGIT_STD)
        kw = dict(causal=True, softcap=50.0)
        want = _dv_check(q, k, v, **kw)
        route = flash_route(dtype, sq, dk, dv)
        _fails_without_softcap(ops.FLASH_KERNELS[route][0], q, k, v, want,
                               **kw)


@pytest.mark.gpu
def test_flash_kernels_dv_mla_shapes():
    """MLA at its published heads (H = Kh = 128, dk 192, dv 128, bf16): a
    prefill of 1,024 on the tensor cores and a decode step over 4,096
    keys, against the plain version."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(30)
    q, k, v = _qkv_dv(gen, 1, 128, 128, 1024, 1024, 192, 128,
                      torch.bfloat16)
    assert flash_route(q.dtype, 1024, 192, 128) == "tc"
    _dv_check(q, k, v, causal=True)
    q, k, v = _qkv_dv(gen, 2, 128, 128, 1, 4096, 192, 128, torch.bfloat16)
    _dv_check(q, k, v, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(1, 300), (40, 40)])
def test_vmapped_flash_op_dv_bitwise_per_user_on_card(sq, sk):
    """The flash op under `torch.func.vmap` at dk 192, dv 128 (the
    per-user MLA decode's call): one launch, bitwise the per-user calls."""
    _require_cuda()
    from torch.func import vmap
    gen = torch.Generator(device="cuda").manual_seed(sq)
    q, k, v = (t.unsqueeze(1) for t in _qkv_dv(
        gen, 3, 4, 4, sq, sk, 192, 128, torch.bfloat16))
    with ops.launches_set_aside() as made:
        got = vmap(lambda a, b, c: ops.flash_attention(a, b, c))(q, k, v)
        torch.cuda.synchronize()
    assert made == {ops.FLASH_COUNTERS[flash_route(q.dtype, sq, 192,
                                                   128)]: 1}
    for i in range(3):
        assert torch.equal(got[i], ops.flash_attention(q[i], k[i], v[i]))


# prefix-LM masks: under ``causal`` the first ``prefix_len`` keys are
# visible to every query (PaliGemma's bidirectional image prefix), the
# window still applying to them


def _fails_without_prefix(kernel, q, k, v, want, **kw):
    """A planted fault: the kernel run with no prefix, where the plain
    version has one, must fail `_flash_close`'s elementwise test: a row
    inside the prefix does see the later prefix keys."""
    bad = kernel(q, k, v, **dict(kw, prefix_len=0)).float()
    w = want.float()
    tol = FLASH_TOL[want.dtype]
    assert not bool(torch.all((bad - w).abs() <= tol + tol * w.abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype,hd,sq,sk", [
    ("tc", torch.bfloat16, 64, 64, 64),
    ("tc", torch.bfloat16, 64, 256, 256),
    ("tc", torch.bfloat16, 256, 256, 256),
    ("tc", torch.bfloat16, 128, 130, 333),
    ("cuda_core", torch.float32, 64, 256, 256),
    ("cuda_core", torch.float32, 80, 130, 333),
    ("decode", torch.float32, 64, 16, 16),
    ("decode", torch.bfloat16, 64, 16, 16),
    ("decode", torch.bfloat16, 256, 3, 70),
])
@pytest.mark.parametrize("prefix", [8, 100, 256, 400])
def test_flash_kernels_prefix_mask(route, dtype, hd, sq, sk, prefix):
    """Each kernel under a prefix (through the op on its route, and its
    own wrapper), with and without a window and a softcap, at prefixes
    inside one tile, across tiles, over all keys and past Sk; against
    the plain version, and failing it when run without the prefix."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(hd + sq + prefix)
    q, k, v = _qkv(gen, 2, 8, 2, sq, sk, hd, dtype, cache_len=sk + 7)
    kernel = {"tc": flash_attention_tc_cuda, "cuda_core":
              flash_attention_cuda, "decode": flash_decode_cuda}[route]
    assert flash_route(dtype, sq, hd) == route
    for kw in (dict(causal=True, prefix_len=prefix),
               dict(causal=True, prefix_len=prefix, window=48,
                    softcap=30.0)):
        want = _flash_check(q, k, v, **kw)
        _flash_close(kernel(q, k, v, **kw), want)
        if "window" not in kw and sk - sq < min(prefix, sk) - 1:
            _fails_without_prefix(kernel, q, k, v, want, **kw)
    assert torch.equal(kernel(q, k, v, causal=True, prefix_len=0),
                       kernel(q, k, v, causal=True))


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype,hd,sq,sk", [
    ("tc", torch.bfloat16, 64, 2048, 1500),
    ("cuda_core", torch.float32, 64, 2048, 1500),
    ("decode", torch.float32, 64, 16, 5),
])
def test_flash_kernels_noncausal_more_queries_than_keys(route, dtype, hd,
                                                        sq, sk):
    """Non-causal with Sq > Sk (the offset Sk − Sq is negative): every
    query sees every key, with and without a window."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(sq)
    q, k, v = _qkv(gen, 2, 6, 6, sq, sk, hd, dtype)
    assert flash_route(dtype, sq, hd) == route
    for kw in (dict(causal=False), dict(causal=False, window=1000)):
        _flash_check(q, k, v, **kw)
