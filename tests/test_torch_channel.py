"""Port uplink channel against the reference, piece by piece, on the CPU.

The channel kernels' plain versions (`repro_torch.kernels.ref`, what the
port's ops run on CPU tensors) against the reference's Pallas kernels in
interpret mode, BITWISE, as the reference pins its own kernels against
its oracles (tests/test_channel.py); then the payload accounting, the
flat view's column order, the codec and link-profile grammars, the
rate-adaptive bindings, the link clock and one error-feedback uplink
crossing fed the reference's own noise, all exactly equal.  The CUDA
kernels are held against the plain versions on the card in
`tests/test_torch_gpu.py` and by `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import channel as jch
from repro.fl.channel import link as jlink
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.fl.strategies import CommCost as JCommCost
from repro.fl.strategies import UniformFraction as JUniformFraction
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lenet as jlenet
from repro_torch.convert import tree_from_numpy
from repro_torch.fl import SYSTEMS, UniformFraction
from repro_torch.fl import channel as ch
from repro_torch.fl.channel import link
from repro_torch.fl.draws import TorchDraws
from repro_torch.fl.strategies import CommCost, FullParticipation
from repro_torch.kernels import _build, ops
from repro_torch.models import lenet

NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
TNARROW = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
M = 4
TINY = np.float32(np.finfo(np.float32).tiny)   # the smallest normal f32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    """Bitwise equality of a tensor and a JAX/numpy array (NaN == NaN)."""
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def stacks():
    """A narrow LeNet client stack (m = 4): pre-round ``prev``, post-update
    ``stacked`` and a non-zero residual ``ef``, as numpy."""
    params = jax.tree_util.tree_map(np.asarray, jlenet.init_params(
        jax.random.PRNGKey(3), NARROW))
    rng = np.random.default_rng(7)
    prev = {k: np.repeat(v[None], M, 0) for k, v in params.items()}
    stacked = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in prev.items()}
    ef = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in prev.items()}
    return params, prev, stacked, ef


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret), bitwise


@pytest.mark.parametrize("m,d", [(5, 1000), (3, 1), (7, 4099), (4, 2048)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_plain_matches_pallas_bitwise(m, d, bits):
    rng = np.random.default_rng(m * 1000 + d + bits)
    x = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    u = rng.uniform(size=(m, d)).astype(np.float32)
    jq, jamax = jops.qsgd_quantize(jnp.asarray(x), jnp.asarray(u), bits=bits)
    q, amax = ops.qsgd_quantize(_t(x), _t(u), bits=bits)
    _same(ops.rowwise_absmax(_t(x)), jamax)
    _same(amax, jamax)
    _same(q, jq)
    _same(ops.qsgd_dequantize(q, amax, bits=bits),
          jops.qsgd_dequantize(jq, jamax, bits=bits))
    _same(ops.qsgd_roundtrip(_t(x), _t(u), bits=bits),
          jops.qsgd_roundtrip(jnp.asarray(x), jnp.asarray(u), bits=bits))


def test_topk_threshold_plain_matches_pallas_bitwise():
    absx = np.abs(np.random.default_rng(0).standard_normal((6, 777))).astype(
        np.float32)
    for k in (1, 10, 200, 777, 778):
        got = ops.topk_threshold(_t(absx), k=k)
        _same(got, jops.topk_threshold(jnp.asarray(absx), k=k))
        if k < 777:
            # one ulp at most below the exact k-th value, exactly k survive
            exact = np.asarray(jref.topk_threshold_ref(jnp.asarray(absx), k))
            assert np.all(got.numpy() <= exact)
            np.testing.assert_allclose(got.numpy(), exact, rtol=3e-7)
            assert np.all((absx >= got.numpy()).sum(1) == k)
        elif k == 777:          # k = D: at or below the row's minimum
            assert np.all(got.numpy() <= absx.min(1, keepdims=True))
        else:                   # k > D: lo never moves from 0
            assert np.all(got.numpy() == 0)


def test_zero_row_gives_zero_scale_levels_and_threshold():
    x = np.random.default_rng(1).standard_normal((3, 300)).astype(np.float32)
    x[1] = 0.0
    u = np.random.default_rng(2).uniform(size=x.shape).astype(np.float32)
    q, amax = ops.qsgd_quantize(_t(x), _t(u), bits=4)
    assert float(amax[1, 0]) == 0.0 and bool(torch.all(q[1] == 0))
    _same(q, jops.qsgd_quantize(jnp.asarray(x), jnp.asarray(u), bits=4)[0])
    assert bool(torch.all(ops.qsgd_roundtrip(_t(x), _t(u), bits=4)[1] == 0))
    th = ops.topk_threshold(_t(np.abs(x)), k=5)
    assert float(th[1, 0]) == 0.0
    _same(th, jops.topk_threshold(jnp.abs(jnp.asarray(x)), k=5))


def test_nan_row_propagates_to_its_scale_and_values():
    x = np.ones((2, 40), np.float32)
    x[0, 7] = np.nan
    u = np.full(x.shape, 0.5, np.float32)
    amax = ops.rowwise_absmax(_t(x))
    assert np.isnan(float(amax[0, 0])) and float(amax[1, 0]) == 1.0
    out = ops.qsgd_roundtrip(_t(x), _t(u), bits=8).numpy()
    assert np.isnan(out[0]).all() and np.isfinite(out[1]).all()
    assert np.isnan(np.asarray(jops.qsgd_roundtrip(
        jnp.asarray(x), jnp.asarray(u), bits=8))[0]).all()


NONFINITE_ROWS = {"nan_coordinate": (3, 777), "pos_inf": (4, 1000),
                  "neg_inf": (2, 33), "all_nan": (5, 129), "zero": (3, 4099),
                  "finite": (1, 7)}


@pytest.mark.parametrize("case", list(NONFINITE_ROWS))
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_nonfinite_rows_match_reference(case, bits):
    """A row holding NaN or ±inf among finite rows: the levels are 0 where
    the reference's float-to-int conversion gives 0 (not PyTorch's CPU
    INT_MIN), so the values are NaN across the row, as both of the
    reference's QSGD paths give; zero and finite rows as before.  Levels
    compared exactly, values with equal NaN masks (no denormal inputs:
    XLA's CPU backend flushes them)."""
    m, d = NONFINITE_ROWS[case]
    rng = np.random.default_rng(bits * 100 + d)
    x = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    u = rng.uniform(size=(m, d)).astype(np.float32)
    r = m // 2
    if case == "nan_coordinate":
        x[r, d // 3] = np.nan
    elif case == "pos_inf":
        x[r, 5] = np.inf
    elif case == "neg_inf":
        x[r, d - 1] = -np.inf
    elif case == "all_nan":
        x[r] = np.nan
    elif case == "zero":
        x[r] = 0.0
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    jq, jamax = jops.qsgd_quantize(jx, ju, bits=bits)
    q, amax = ops.qsgd_quantize(_t(x), _t(u), bits=bits)
    _same(q, jq)
    _same(amax, jamax)
    got = ops.qsgd_roundtrip(_t(x), _t(u), bits=bits)
    _same(got, jops.qsgd_roundtrip(jx, ju, bits=bits))
    _same(got, jref.qsgd_roundtrip_ref(jx, ju, bits))
    _same(ops.qsgd_dequantize(q, amax, bits=bits),
          jops.qsgd_dequantize(jq, jamax, bits=bits))
    row = got[r].numpy()
    if case in ("zero", "finite"):
        assert np.isfinite(got.numpy()).all()
    else:
        assert np.isnan(row).all()
        assert int(q[r].abs().max()) <= 2 ** (bits - 1) - 1
    assert np.isfinite(np.delete(got.numpy(), r, axis=0)).all()


def _subnormal_scalar_rows() -> np.ndarray:
    """(11, 64) f32 rows whose QSGD scalars leave f32's normal range,
    between ordinary rows (0, 3, 6, 10): rows 1-2 ±1e-37 (scale
    subnormal at bits 8), rows 4-5 ±0.5 with one 1.7e38 in row 5 (inv
    subnormal at bits 2), rows 7-8 all 1e-40 (absmax subnormal), row 9
    magnitudes in [1e-37, 4e-37), every element normal (scale subnormal
    at bits 8)."""
    rng = np.random.default_rng(37)
    x = (rng.standard_normal((11, 64)) * 3).astype(np.float32)
    sign = np.where(rng.uniform(size=(11, 64)) < 0.5, -1, 1).astype(
        np.float32)
    x[1:3] = np.float32(1e-37) * sign[1:3]
    x[4:6] = np.float32(0.5) * sign[4:6]
    x[5, 17] = np.float32(1.7e38)
    x[7:9] = np.float32(1e-40)
    x[9] = (1e-37 * (1 + 3 * rng.uniform(size=64))).astype(np.float32) \
        * sign[9]
    return x


@pytest.mark.parametrize("bits", [2, 3, 8])
def test_qsgd_subnormal_scalars_match_reference(bits):
    """The reference's XLA run flushes a subnormal absmax, scale or 1/scale
    to 0, so such a row crosses as zeros: the port's levels, absmax and
    values bitwise equal the Pallas ops' (interpret mode) and the
    reference's adaptive codec at the same width, and the ordinary rows
    and rows whose scalars are normal are bitwise as before the flush."""
    x = _subnormal_scalar_rows()
    u = np.random.default_rng(bits).uniform(size=x.shape).astype(np.float32)
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    jq, jamax = jops.qsgd_quantize(jx, ju, bits=bits)
    q, amax = ops.qsgd_quantize(_t(x), _t(u), bits=bits)
    _same(amax, jamax)
    _same(ops.rowwise_absmax(_t(x)), jamax)
    _same(q, jq)
    got = ops.qsgd_roundtrip(_t(x), _t(u), bits=bits)
    _same(got, jops.qsgd_roundtrip(jx, ju, bits=bits))
    _same(ops.qsgd_dequantize(q, amax, bits=bits),
          jops.qsgd_dequantize(jq, jamax, bits=bits))
    # the rate-adaptive codec's plain arithmetic, every row at this width
    key = jax.random.PRNGKey(bits)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    widths = np.full(x.shape[0], bits, np.int64)
    _same(ch.BoundAdaptive("adaptive", widths).roundtrip(_t(x), _t(noise)),
          jch.BoundAdaptive("adaptive", widths).roundtrip(jx, key))
    assert float(amax[7, 0]) == 0.0 and bool(torch.all(got[7:9] == 0))
    s = 2 ** (bits - 1) - 1
    flushed = [1, 2, 9] if 1e-37 * 4 / s < TINY else []
    if bits == 2:
        flushed.append(5)
    assert bool(torch.all(got[flushed] == 0))


def _subnormal_element_rows():
    """(x, u), (8, 64) f32: rows holding subnormal elements with normal
    scalars, between ordinary rows (0, 7).  Row 1 is 2e-36 (a normal scale
    at bits 8) with its odd elements 5e-39, at u = 0.9: x·(1/scale) of
    such an element is 0.32, so its level is 1 unless it is read as 0;
    row 2 random with a quarter of its elements ±[1e-45, 1e-38); row 3
    the same at magnitudes near 1e-36; row 4 ±0.5 with one 1.7e38 and
    subnormal elements (inv subnormal at bits 2); row 5 ±[1e-39, 1.1e-38)
    with one 1.2e-38, at u = 0.95 (at bits 2 a normal scale, and levels 1
    unless the elements are read as 0; a subnormal scale above); row 6 a
    NaN among subnormals."""
    rng = np.random.default_rng(39)
    x = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    u = rng.uniform(size=x.shape).astype(np.float32)
    sign = np.where(rng.uniform(size=x.shape) < 0.5, -1, 1).astype(
        np.float32)
    tiny = (np.exp(rng.uniform(np.log(1e-45), np.log(1e-38), x.shape))
            * sign).astype(np.float32)
    x[1] = np.float32(2e-36)
    x[1, 1::2] = np.float32(5e-39)
    u[1] = np.float32(0.9)
    sub = rng.uniform(size=x.shape) < 0.25
    x[2] = np.where(sub[2], tiny[2], x[2])
    x[3] = np.where(sub[3], tiny[3], x[3] * np.float32(1e-36))
    x[4] = np.where(sub[4], tiny[4], np.float32(0.5) * sign[4])
    x[4, 9] = np.float32(1.7e38)
    x[5] = (rng.uniform(1e-39, 1.1e-38, 64) * sign[5]).astype(np.float32)
    x[5, 30] = np.float32(1.2e-38)
    u[5] = np.float32(0.95)
    x[6] = tiny[6]
    x[6, 3] = np.nan
    assert (np.abs(x[1:7]) < TINY).any(axis=1).all()
    return x, u


@pytest.mark.parametrize("bits", [2, 3, 8])
def test_qsgd_subnormal_elements_match_reference(bits):
    """The reference's XLA run reads a subnormal element of x as 0, so its
    level is floor(u) = 0: the port's levels, absmax, values and the
    rate-adaptive codec bitwise equal the Pallas ops' (interpret mode) and
    the reference's `BoundAdaptive` on rows that hold such elements
    beside normal ones (row 1: the port gave level 1 before the flush)."""
    x, u = _subnormal_element_rows()
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    jq, jamax = jops.qsgd_quantize(jx, ju, bits=bits)
    q, amax = ops.qsgd_quantize(_t(x), _t(u), bits=bits)
    _same(amax, jamax)
    _same(ops.rowwise_absmax(_t(x)), jamax)
    _same(q, jq)
    got = ops.qsgd_roundtrip(_t(x), _t(u), bits=bits)
    _same(got, jops.qsgd_roundtrip(jx, ju, bits=bits))
    _same(ops.qsgd_dequantize(q, amax, bits=bits),
          jops.qsgd_dequantize(jq, jamax, bits=bits))
    sub = np.abs(x) < TINY
    assert bool(torch.all(q[torch.from_numpy(sub)] == 0))
    if bits == 8:
        assert bool(torch.all(q[1, 1::2] == 0)) and int(q[1, 0]) == 127
    key = jax.random.PRNGKey(bits + 10)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    widths = np.full(x.shape[0], bits, np.int64)
    _same(ch.BoundAdaptive("adaptive", widths).roundtrip(_t(x), _t(noise)),
          jch.BoundAdaptive("adaptive", widths).roundtrip(jx, key))
    # rows without subnormal elements: bitwise the unflushed arithmetic
    plain = [0, 7]
    xp, up = _t(x[plain]), _t(u[plain])
    _same(ops.qsgd_roundtrip(xp, up, bits=bits), got.numpy()[plain])


def test_topk_subnormal_elements_match_pallas():
    """Top-k reads a subnormal element as it is, and agrees with the Pallas
    op (interpret mode) and the reference's top-k codec all the same: its
    threshold is 0 or normal, so the mask ``|x| >= t`` is the one the
    reference's flushed read gives.  Rows of 1e-3 with subnormal
    elements, all-subnormal rows (threshold 0: every element kept as is)
    and zero rows with one subnormal, at k = 1, D - 1, D and D + 1."""
    rng = np.random.default_rng(41)
    d = 128
    flat = np.full((5, d), 1e-3, np.float32) * np.where(
        rng.uniform(size=(5, d)) < 0.5, -1, 1).astype(np.float32)
    flat[0, 5] = np.float32(5e-39)
    flat[1, ::3] = np.float32(-1e-40)
    flat[2] = np.float32(5e-39)
    flat[2, 7] = 0.0
    flat[3] = 0.0
    flat[3, 3] = np.float32(-5e-39)
    flat[4] = (rng.uniform(size=d) * 1e-38).astype(np.float32)
    jflat = jnp.asarray(flat)
    for k in (1, d - 1, d, d + 1):
        jt = jops.topk_threshold(jnp.abs(jflat), k=k)
        t = ops.topk_threshold(_t(flat).abs(), k=k)
        _same(t, jt)
        tf = _t(flat)
        got = torch.where(tf.abs() >= t, tf, torch.zeros_like(tf))
        want = jnp.where(jnp.abs(jflat) >= jt, jflat, 0.0)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    codec, jcodec = ch.TopK(frac=1.0), jch.TopK(frac=1.0)
    np.testing.assert_array_equal(
        codec.roundtrip(_t(flat), None).numpy().view(np.int32),
        np.asarray(jcodec.roundtrip(jflat, jax.random.PRNGKey(0))).view(
            np.int32))


def test_cpu_channel_ops_count_no_launches_and_refuse_bad_args():
    before = dict(ops.LAUNCHES)
    x = torch.randn(3, 50)
    ops.qsgd_roundtrip(x, torch.rand(3, 50), bits=4)
    ops.topk_threshold(x.abs(), k=3)
    assert ops.LAUNCHES == before
    for bits in (1, 9):
        with pytest.raises(ValueError, match="bits"):
            ops.qsgd_quantize(x, torch.rand(3, 50), bits=bits)
    with pytest.raises(ValueError, match="k must be"):
        ops.topk_threshold(x.abs(), k=0)


def test_nvcc_flags_keep_ieee_arithmetic():
    # the QSGD kernels rely on IEEE division and on denormals
    for flag in ("--use_fast_math", "-use_fast_math", "-prec-div=false",
                 "-ftz=true"):
        assert flag not in _build.NVCC_FLAGS
    assert {"quantize", "topk_threshold"} <= {
        p.stem for p in _build.CSRC.glob("*.cu")}


# ---------------------------------------------------------------------------
# payload accounting and the flat view


def test_stacked_ravel_order_and_roundtrip_bitwise(stacks):
    _, _, stacked, _ = stacks
    # the port's LeNet dict order (conv1_w, conv1_b, ...), not sorted
    order = lenet.init_params(torch.Generator().manual_seed(0), TNARROW,
                              device="cpu")
    st = {k: torch.from_numpy(stacked[k]) for k in order}
    flat = ch.stacked_ravel(st)
    _same(flat, jch.stacked_ravel({k: jnp.asarray(v)
                                   for k, v in stacked.items()}))
    assert list(st) != sorted(st)      # insertion order differs: sorted wins
    back = ch.stacked_unravel(flat, st)
    assert list(back) == list(st)
    for k, v in back.items():
        assert v.shape == st[k].shape and torch.equal(v, st[k])
    with pytest.raises(ValueError, match="columns"):
        ch.stacked_unravel(flat[:, 1:], st)


def test_tree_bits_and_every_codec_payload(stacks):
    params = stacks[0]
    tp = tree_from_numpy(params, "cpu")
    assert ch.tree_bits(tp) == jch.tree_bits(params)
    assert ch.tree_size(tp) == jch.tree_size(params)
    assert ch.tree_bits({"b": torch.zeros(7, dtype=torch.bfloat16),
                         "i": torch.zeros(2, dtype=torch.int8)}) == 7 * 16 + 16
    assert ch.dtype_bits(np.float32) == ch.dtype_bits(torch.float32) == 32
    for spec in ("identity", "qsgd:2", "qsgd:8", "topk:0.1", "topk:0.001",
                 "topk:1"):
        assert ch.get_codec(spec).payload_bits(tp) == \
            jch.get_codec(spec).payload_bits(params), spec
    lp = link.get_link_profile("lognormal:0.5", SYSTEMS["wireless_slow"],
                               ch.tree_bits(tp), 6)
    jlp = jlink.get_link_profile("lognormal:0.5", J_SYSTEMS["wireless_slow"],
                                 jch.tree_bits(params), 6)
    for spec in ("adaptive", "adaptive:4", "adaptive_topk",
                 "adaptive_topk:0.1:0.5"):
        got = ch.get_codec(spec).bind_link(lp, tp)
        want = jch.get_codec(spec).bind_link(jlp, params)
        assert got.spec == want.spec == spec
        assert got.payload_bits(tp) == want.payload_bits(params)
        np.testing.assert_array_equal(got.per_client_bits(tp, 6),
                                      want.per_client_bits(params, 6))
        vec = got.bits if hasattr(got, "bits") else got.ks
        np.testing.assert_array_equal(
            vec, want.bits if hasattr(want, "bits") else want.ks)
        assert len(set(vec.tolist())) > 1       # lognormal spreads them
        with pytest.raises(RuntimeError, match="bind_link"):
            ch.get_codec(spec).payload_bits(tp)


def test_codec_grammar_and_errors():
    for spec in ("identity", "qsgd:4", "topk:0.25", "adaptive",
                 "adaptive:3", "adaptive:3:6", "adaptive_topk",
                 "adaptive_topk:0.1", "adaptive_topk:0.1:0.5"):
        assert ch.get_codec(spec).spec == jch.get_codec(spec).spec == spec
    assert ch.get_codec(ch.get_codec("qsgd:4")) == ch.get_codec("qsgd:4")
    assert ch.get_codec("identity").is_identity
    assert ch.get_codec("qsgd:8").needs_noise
    assert not ch.get_codec("topk:0.1").needs_noise
    assert sorted(ch.CODECS) == sorted(jch.CODECS)
    for bad in ("nope", "qsgd:1", "qsgd:9", "qsgd:x", "topk:0", "topk:1.5",
                "adaptive:9", "adaptive:5:3", "adaptive_topk:0",
                "qsgd:4:4"):
        with pytest.raises(ValueError):
            jch.get_codec(bad)
        with pytest.raises(ValueError):
            ch.get_codec(bad)
    # the at-rest format (the serving plane): decode round-trips encode,
    # and a top-k payload needs the dense width
    x = torch.tensor([[0.5, -2.0, 1.0], [0.0, 0.0, 0.0]])
    u = torch.full((2, 3), 0.25)
    for spec, noise in (("identity", None), ("qsgd:4", u),
                        ("topk:1.0", None)):
        c = ch.get_codec(spec)
        assert torch.equal(c.decode(c.encode(x, noise), d=3),
                           c.roundtrip(x, noise))
    with pytest.raises(ValueError, match="dense width"):
        ch.get_codec("topk:0.5").decode(ch.get_codec("topk:0.5").encode(
            x, None))


def test_link_grammar_and_channel_resolution():
    sysm = SYSTEMS["wireless_slow"]
    for spec in ("uniform", "tiered", "tiered:4", "lognormal",
                 "lognormal:0.5"):
        got = link.get_link_profile(spec, sysm, 1000, 6)
        want = jlink.get_link_profile(spec, J_SYSTEMS["wireless_slow"],
                                      1000, 6)
        assert got.name == want.name
        np.testing.assert_array_equal(got.dl_rate, want.dl_rate)
        np.testing.assert_array_equal(got.ul_ratio, want.ul_ratio)
    for bad in ("warp", "tiered:x", "tiered:0.5", "lognormal:-1",
                "uniform:2"):
        with pytest.raises(ValueError):
            link.get_link_profile(bad, sysm, 1000, 6)
    with pytest.raises(ValueError):
        link.LinkProfile(dl_rate=np.ones(3), ul_ratio=-np.ones(3))
    with pytest.raises(ValueError, match="unknown link profile"):
        ch.Channel(link="warp")
    assert ch.resolve_channel(None) is None
    c = ch.resolve_channel("qsgd:4")
    assert c.codec.spec == "qsgd:4" and c.error_feedback and c.link is None
    assert ch.resolve_channel(c) is c
    assert c.resolve_link(sysm, 1000, 6).name == "uniform"


@pytest.mark.parametrize("spec", ["uniform", "tiered:4", "lognormal:0.5"])
def test_round_downlink_time_exact(spec):
    sysm, jsys = SYSTEMS["wireless_slow"], J_SYSTEMS["wireless_slow"]
    lp = link.get_link_profile(spec, sysm, 1522272, 6)
    jlp = jlink.get_link_profile(spec, jsys, 1522272, 6)
    asn = np.array([0, 1, 0, 1, 2, 2])
    for cost in ((1, 0), (3, 0), (2, 2), (0, 0)):
        for part in (None, [0, 1, 4], [3], []):
            for a in (None, asn):
                got = link.round_downlink_time(lp, CommCost(*cost), 380600,
                                               part, a)
                want = jlink.round_downlink_time(jlp, JCommCost(*cost),
                                                 380600, part, a)
                assert got == want, (cost, part, a)
        assert lp.max_uplink_time(380600, [1, 2]) == \
            jlp.max_uplink_time(380600, [1, 2])
    if spec == "uniform":       # the identity anchor: exactly 1 T_dl, ρ up
        assert lp.downlink_time(1522272) == 1.0
        assert lp.max_uplink_time(1522272) == sysm.rho
    with pytest.raises(ValueError, match="assignment"):
        link.round_downlink_time(lp, CommCost(1, 0), 10, None, np.zeros(3))


# ---------------------------------------------------------------------------
# one uplink crossing with error feedback


@pytest.mark.parametrize("spec", ["qsgd:4", "qsgd:8", "topk:0.25",
                                  "adaptive", "adaptive_topk"])
@pytest.mark.parametrize("masked", [True, False])
def test_uplink_roundtrip_matches_reference_bitwise(stacks, spec, masked):
    params, prev, stacked, ef = stacks
    key = jax.random.PRNGKey(11)
    mask = np.array([True, False, True, True]) if masked else None
    jp = {k: jnp.asarray(v) for k, v in prev.items()}
    js = {k: jnp.asarray(v) for k, v in stacked.items()}
    je = {k: jnp.asarray(v) for k, v in ef.items()}
    jcodec, codec = jch.get_codec(spec), ch.get_codec(spec)
    if spec.startswith("adaptive"):
        jlp = jlink.get_link_profile("lognormal:0.5", J_SYSTEMS["wired"],
                                     jch.tree_bits(params), M)
        lp = link.get_link_profile("lognormal:0.5", SYSTEMS["wired"],
                                   jch.tree_bits(params), M)
        jcodec = jcodec.bind_link(jlp, params)
        codec = codec.bind_link(lp, tree_from_numpy(params, "cpu"))
    want_s, want_e = jch.apply_uplink(
        jcodec, js, jp, je, key, None if mask is None else jnp.asarray(mask))
    # the reference draws uniform(key, (m, D)) inside its codec
    d = jch.tree_size(params)
    noise = _t(np.asarray(jax.random.uniform(key, (M, d), jnp.float32)))
    got_s, got_e = ch.apply_uplink(
        codec, tree_from_numpy(stacked, "cpu"), tree_from_numpy(prev, "cpu"),
        tree_from_numpy(ef, "cpu"), noise if codec.needs_noise else None,
        None if mask is None else torch.from_numpy(mask))
    for k in params:
        _same(got_s[k], want_s[k])
        _same(got_e[k], want_e[k])
    if masked:                          # the row that sent nothing
        np.testing.assert_array_equal(got_s["fc1_w"][1].numpy(),
                                      stacked["fc1_w"][1])
        np.testing.assert_array_equal(got_e["fc1_w"][1].numpy(),
                                      ef["fc1_w"][1])


@pytest.mark.parametrize("spec", ["qsgd:4", "qsgd:8", "topk:0.25",
                                  "topk:0.05", "adaptive", "adaptive_topk"])
@pytest.mark.parametrize("masked", [True, False])
def test_uplink_roundtrip_jnp_backend_matches_reference(stacks, spec,
                                                        masked):
    """The mesh placement's codec backend: the reference's ``"jnp"``
    crossing, bitwise (top-k keeps |x| >= the exact k-th magnitude)."""
    params, prev, stacked, ef = stacks
    key = jax.random.PRNGKey(13)
    mask = np.array([True, True, False, True]) if masked else None
    jcodec, codec = jch.get_codec(spec), ch.get_codec(spec)
    if spec.startswith("adaptive"):
        jcodec = jcodec.bind_link(jlink.get_link_profile(
            "tiered:4", J_SYSTEMS["wired"], jch.tree_bits(params), M),
            params)
        codec = codec.bind_link(link.get_link_profile(
            "tiered:4", SYSTEMS["wired"], jch.tree_bits(params), M),
            tree_from_numpy(params, "cpu"))
    want_s, want_e = jch.apply_uplink(
        jcodec, *({k: jnp.asarray(v) for k, v in t.items()}
                  for t in (stacked, prev, ef)),
        key, None if mask is None else jnp.asarray(mask), backend="jnp")
    d = jch.tree_size(params)
    noise = _t(np.asarray(jax.random.uniform(key, (M, d), jnp.float32)))
    got_s, got_e = ch.apply_uplink(
        codec, *(tree_from_numpy(t, "cpu") for t in (stacked, prev, ef)),
        noise if codec.needs_noise else None,
        None if mask is None else torch.from_numpy(mask), backend="jnp")
    if not codec.needs_noise:
        for k in params:
            _same(got_s[k], want_s[k])
            _same(got_e[k], want_e[k])
    else:
        # the reference's jnp crossing is one XLA fusion, which contracts
        # prev + level·scale (and v − level·scale) into FMAs where its
        # kernel path (and the port's, on both backends) rounds the
        # product first: values one rounding apart, levels equal
        for k in params:
            np.testing.assert_allclose(got_s[k].numpy(), want_s[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(got_e[k].numpy(), want_e[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        # the port's two backends are one path, bitwise
        pal_s, pal_e = ch.apply_uplink(
            codec, *(tree_from_numpy(t, "cpu") for t in (stacked, prev, ef)),
            noise, None if mask is None else torch.from_numpy(mask))
        for k in params:
            assert torch.equal(pal_s[k], got_s[k])
            assert torch.equal(pal_e[k], got_e[k])
    with pytest.raises(ValueError, match="backend"):
        ch.apply_uplink(codec, got_s, got_s, got_e, noise, backend="xla")


def _planted_rows(d=64):
    """Rows that stress the exact top-k mask: ties at the cut, NaN among
    finite values, all NaN, all zero, ±inf, signed zeros, one value."""
    rng = np.random.default_rng(4)
    rows = [rng.standard_normal(d)]
    tie = rng.standard_normal(d)
    tie[::3] = 0.75                      # a run of ties across the cut
    tie[1::7] = -0.75
    rows.append(tie)
    nan = rng.standard_normal(d)
    nan[[2, 9, 40]] = np.nan
    rows.append(nan)
    rows.append(np.full(d, np.nan))
    rows.append(np.zeros(d))
    inf = rng.standard_normal(d)
    inf[[5, 6]] = [np.inf, -np.inf]
    rows.append(inf)
    sz = np.zeros(d)
    sz[::2] = -0.0
    sz[10] = 3.0
    rows.append(sz)
    rows.append(np.full(d, -2.5))        # every coordinate tied
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 8, 21, 63, 64])
def test_topk_exact_mask_on_planted_rows(k):
    """The ``"jnp"`` top-k against the reference's `topk_mask_ref`
    (`jax.lax.top_k`'s k-th magnitude) bitwise, on ties, NaN rows and
    zero rows; encode keeps the first-index ties of ``lax.top_k``."""
    x = _planted_rows()
    codec = ch.get_codec(f"topk:{k / x.shape[1]}")
    assert codec.k(x.shape[1]) == k
    want = np.asarray(jnp.where(jref.topk_mask_ref(jnp.asarray(x), k),
                                jnp.asarray(x), 0.0))
    got = codec.roundtrip(_t(x), None, backend="jnp")
    _same(got, want)
    jenc = jch.get_codec(f"topk:{k / x.shape[1]}").encode(
        jnp.asarray(x), None, backend="jnp")
    enc = codec.encode(_t(x), None)
    fin = np.isfinite(x).all(1)         # lax.top_k orders NaN by its own rule
    np.testing.assert_array_equal(enc["indices"].numpy()[fin],
                                  np.asarray(jenc["indices"])[fin])


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_bitwise_across_backends(bits):
    """QSGD runs the same kernels on both backends: roundtrip, encode and
    decode bitwise each other and the reference's ``"jnp"`` path."""
    x = _planted_rows(300)
    x = np.where(np.isfinite(x), x, 1.0).astype(np.float32)
    u = np.random.default_rng(9).uniform(size=x.shape).astype(np.float32)
    codec, jcodec = ch.get_codec(f"qsgd:{bits}"), jch.get_codec(
        f"qsgd:{bits}")
    outs = {b: codec.roundtrip(_t(x), _t(u), backend=b)
            for b in ch.BACKENDS}
    _same(outs["jnp"], outs["pallas"].numpy())
    _same(outs["jnp"], jref.qsgd_roundtrip_ref(jnp.asarray(x),
                                               jnp.asarray(u), bits))
    enc = codec.encode(_t(x), _t(u))
    _same(codec.decode(enc), outs["pallas"].numpy())
    jenc = {"levels": jnp.asarray(enc["levels"].numpy()),
            "absmax": jnp.asarray(enc["absmax"].numpy())}
    _same(codec.decode(enc), jcodec.decode(jenc, backend="jnp"))


def test_topk_residual_conservation_and_identity_noop(stacks):
    _, prev, stacked, ef = stacks
    s, p, e = (tree_from_numpy(t, "cpu") for t in (stacked, prev, ef))
    v = {k: (s[k] - p[k]) + e[k] for k in s}
    for frac in (0.05, 0.25, 1.0):
        codec = ch.get_codec(f"topk:{frac}")
        new_s, new_e = ch.uplink_roundtrip(codec, s, p, e, None, None)
        dec = {k: new_s[k] - p[k] for k in s}
        flat_dec = ch.stacked_ravel(ch.stacked_unravel(
            codec.roundtrip(ch.stacked_ravel(v), None), v))
        # kept coordinates cross verbatim, dropped ones land whole in e'
        assert torch.equal(ch.stacked_ravel(new_e) + flat_dec,
                           ch.stacked_ravel(v))
        kept = (flat_dec != 0).sum(1)
        assert bool(torch.all(kept >= codec.k(flat_dec.shape[1])))
        assert all(torch.isfinite(t).all() for t in dec.values())
    same_s, same_e = ch.apply_uplink(ch.get_codec("identity"), s, p, e, None)
    assert same_s is s and same_e is e
    zeros = ch.zeros_like_stack(s)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in zeros.values())


# ---------------------------------------------------------------------------
# samplers


def test_uniform_fraction_mask_replays_the_reference():
    key = jax.random.PRNGKey(5)

    class OneDraw:
        def permutation(self, rnd, m):
            return torch.from_numpy(np.asarray(jax.random.permutation(key, m),
                                               np.int64))

    for kw in (dict(fraction=0.5), dict(count=3), dict(fraction=0.05,
                                                       min_clients=2)):
        got = UniformFraction(**kw).sample(0, 10, OneDraw())
        want = JUniformFraction(**kw).sample(0, 10, key)
        assert got.dtype == torch.bool and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert UniformFraction(1.0).sample(0, 10, None) is None   # no draw spent
    assert FullParticipation().sample(0, 10, None) is None
    assert UniformFraction.needs_key and not FullParticipation.needs_key
    mask = UniformFraction(0.5).sample(0, 20, TorchDraws(3, "cpu"))
    assert int(mask.sum()) == 10
    for bad in (dict(), dict(fraction=0.5, count=2), dict(fraction=0.0),
                dict(count=0)):
        with pytest.raises(ValueError):
            UniformFraction(**bad)


def test_torch_draws_codec_noise_and_permutation():
    d1, d2 = TorchDraws(4, "cpu"), TorchDraws(4, "cpu")
    a, b = d1.codec_noise(0, (3, 17)), d2.codec_noise(0, (3, 17))
    assert a.dtype == torch.float32 and a.shape == (3, 17)
    assert torch.equal(a, b) and bool((a >= 0).all() & (a < 1).all())
    assert not torch.equal(d1.codec_noise(1, (3, 17)), a)
    p = d1.permutation(0, 12)
    assert sorted(p.tolist()) == list(range(12))
    assert torch.equal(p, d2.permutation(0, 12))
