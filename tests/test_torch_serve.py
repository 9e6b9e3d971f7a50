"""Port serving plane and the rest of the core API against the reference.

The reference's narrow-LeNet ``params0`` plus seeded perturbations is the
stacked "final params" (m = 6) both packages serve from, as numpy; the
qsgd noise is the reference's ``jax.random.uniform(PRNGKey(seed), (m,
D))``, injected.  Held bitwise: the codecs' at-rest payloads (zero, tied
and subnormal rows included), `DeltaStore.build`'s contents and bits for
each codec on a coarse assignment (nonzero deltas, one identity fixup
forced) and on the byte-level dedup, reconstructions, and saved store
files (byte for byte, each package loading the other's).  Served logits
match the reference engine's at tests/test_torch_lenet.py's atol 1e-5
with equal argmax.  The port's own contracts: `check_parity` for every
codec (and its refusal of a planted wrong row), the micro-batcher's
(outputs in submit order, each bitwise a batch-1 serve on the CPU), its
refusals, and `from_history` on small port runs.  Then item 3 of the
core API at stated tolerances (`tests/test_core.py`'s cases).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
from repro import checkpoint as jckpt
from repro.fl.channel import get_codec as j_get_codec
from repro.fl.serve import DeltaStore as JDeltaStore
from repro.fl.serve import ServeEngine as JServeEngine
from repro.models import lenet as jlenet
import repro_torch.core as C
from repro_torch import checkpoint
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (DeltaStore, FLConfig, MeshShardMap, ServeEngine,
                            StoreBits, check_parity, run_federated)
from repro_torch.fl.channel import get_codec, stacked_ravel
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lenet

NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
TNARROW = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
M = 6
GROUPS = np.asarray([0, 0, 1, 1, 2, 2], np.int64)     # the coarse streams
SEED = 3
CODECS = ["identity", "qsgd:4", "topk:0.25"]
# planted so that no single f32 delta reaches user 5's element from its
# base (user 4): the identity store needs its sparse fixup
FIX_AT = (("fc1_w", (0, 0), 1.0, 1e-9), ("fc1_w", (3, 2), -3.0, 2e-9),
          ("out_b", (5,), 0.75, -1e-10))


def japply_one(params, x):
    return jlenet.apply(params, x[None])[0]


def apply_one(params, x):
    return lenet.apply(params, x[None])[0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    """Bitwise equality of a tensor / array and a JAX / numpy array."""
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype,
                                                       g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.fixture(scope="module")
def stacks():
    """``full``: every user its own model (group offset + personal noise,
    the fixup elements planted); ``streamed``: users of a group bitwise
    identical (the dedup recovers the groups)."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlenet.init_params, static_argnums=1)(jax.random.PRNGKey(1), NARROW))
    rng = np.random.default_rng(11)
    full, streamed = {}, {}
    for k, v in params.items():
        sd = float(np.std(v)) or 0.05
        grp = 0.1 * sd * rng.standard_normal((3,) + v.shape)
        own = 0.01 * sd * rng.standard_normal((M,) + v.shape)
        streamed[k] = (v[None] + grp[GROUPS]).astype(np.float32)
        full[k] = (streamed[k] + own).astype(np.float32)
    for leaf, at, base, tiny in FIX_AT:
        full[leaf][(4,) + at] = base
        full[leaf][(5,) + at] = tiny
    rng2 = np.random.default_rng(12)
    xs = rng2.standard_normal((M, 28, 28, 1)).astype(np.float32)
    return full, streamed, xs


def _d(stack):
    return int(sum(np.prod(v.shape[1:]) for v in stack.values()))


def _noise(m, d, seed=SEED):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (m, d),
                                         jnp.float32))


def _stores(stack, asn, codec):
    """The reference's store and the port's (on the CPU) of ``stack``."""
    want = JDeltaStore.build(stack, assignment=asn, codec=codec, seed=SEED)
    got = DeltaStore.build(stack, assignment=asn, codec=codec, seed=SEED,
                           noise=_noise(M, _d(stack)), device="cpu")
    return got, want


@pytest.fixture(scope="module")
def stores(stacks):
    full, streamed, _ = stacks
    out = {}
    for codec in CODECS:
        out[codec, "coarse"] = _stores(full, GROUPS, codec)
        out[codec, "dedup"] = _stores(streamed, None, codec)
    return out


# ---------------------------------------------------------------------------
# codecs at rest


def _rows(d=96):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, d)) * 2).astype(np.float32)
    x[1] = 0.0                                          # a zero row
    x[2] = np.tile(np.float32([1.0, -1.0, 0.5, -0.5, 0.0, 1.0]), d // 6)
    x[3] = (rng.standard_normal(d) * 1e-39).astype(np.float32)  # subnormal
    x[4, ::5] = np.float32(-3e-39)                      # subnormals inside
    x[5, :10] = x[5, 10]                                # ties in a row
    return x


@pytest.mark.parametrize("spec", ["identity", "qsgd:2", "qsgd:4", "qsgd:8",
                                  "topk:0.25", "topk:1.0"])
def test_codec_at_rest_matches_reference(spec):
    x = _rows()
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    jc, c = j_get_codec(spec), get_codec(spec)
    want = jc.encode(jnp.asarray(x), key, backend="pallas")
    got = c.encode(_t(x), _t(u) if c.needs_noise else None)
    assert sorted(got) == sorted(want)
    for name in want:
        _same(got[name], want[name])
    dec = c.decode(got, d=x.shape[1])
    _same(dec, jc.decode(want, backend="pallas", d=x.shape[1]))
    # decode(encode) == roundtrip, bitwise; for top-k (as in the
    # reference) on the rows without ties at the k-th magnitude (roundtrip
    # keeps every tied coordinate) and without subnormals (decode flushes
    # them, roundtrip selects them as they are)
    rows = [0, 1] if spec.startswith("topk") else list(range(len(x)))
    _same(dec[rows], c.roundtrip(_t(x), _t(u) if c.needs_noise
                                 else None)[rows])
    host = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(c.store_bound(got, x.shape[1]),
                                  jc.store_bound(host, x.shape[1]))


def test_codec_decode_of_gathered_rows():
    x = _rows()
    for spec in ("qsgd:4", "topk:0.25"):
        c = get_codec(spec)
        u = torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
        pay = c.encode(_t(x), u)
        rows = torch.tensor([4, 0, 4])
        part = c.decode({k: v[rows] for k, v in pay.items()}, d=x.shape[1])
        _same(part, c.decode(pay, d=x.shape[1])[rows])
    with pytest.raises(ValueError, match="dense width"):
        get_codec("topk:0.25").decode(pay)


# ---------------------------------------------------------------------------
# DeltaStore: contents and bits bitwise the reference's


@pytest.mark.parametrize("mode", ["coarse", "dedup"])
@pytest.mark.parametrize("codec", CODECS)
def test_store_build_matches_reference(stores, codec, mode):
    got, want = stores[codec, mode]
    assert got.k == want.k == 3
    np.testing.assert_array_equal(got.assignment, want.assignment)
    _same(got.base_flat, want.base_flat)
    assert sorted(got.payload) == sorted(want.payload)
    for name in want.payload:
        _same(got.payload[name], want.payload[name])
    _same(got.fix_values, want.fix_values)
    _same(got.fix_indices, want.fix_indices)
    _same(got.recon_err, want.recon_err)
    assert got.bits.base_bits == want.bits.base_bits
    _same(got.bits.delta_bits, want.bits.delta_bits)
    assert got.bits.total_bytes == want.bits.total_bytes
    assert got.summary() == want.summary()
    _same(got.params_flat(), want.params_flat())
    users = [5, 0, 3, 3]
    _same(got.params_flat(users), want.params_flat(users))
    gp, wp = got.params(users), want.params(users)
    assert set(gp) == set(wp)
    for k in wp:
        _same(gp[k], wp[k])
    if mode == "coarse" and codec != "identity":
        assert got.recon_err.max() > 0          # the bound does real work


def test_identity_store_forces_fixup_and_is_lossless(stacks, stores):
    full, streamed, _ = stacks
    got, _ = stores["identity", "coarse"]
    # the planted elements are among user 5's fixups (with others the
    # refinement could not reach)
    names = sorted(full)
    offs = np.cumsum([0] + [full[k][0].size for k in names])
    planted = {int(offs[names.index(leaf)]
                   + np.ravel_multi_index(at, full[leaf].shape[1:]))
               for leaf, at, _, _ in FIX_AT}
    n5 = int(np.count_nonzero(got.fix_values[5].numpy()))
    assert planted <= set(got.fix_indices[5, :n5].tolist())
    assert got.recon_err.max() == 0.0
    flat = np.asarray(stacked_ravel(_tree(full)))
    _same(got.params_flat(), flat)
    ded, _ = stores["identity", "dedup"]
    _same(ded.params_flat(), np.asarray(stacked_ravel(_tree(streamed))))
    # the dedup's labels follow np.unique's row order: the same partition
    assert len(set(zip(ded.assignment.tolist(), GROUPS.tolist()))) == 3
    bits = ded.bits
    assert isinstance(bits, StoreBits)
    assert bits.total_bits == bits.base_bits + int(bits.delta_bits.sum())


def _tree(stack):
    return {k: _t(v) for k, v in stack.items()}


@pytest.mark.parametrize("codec", CODECS)
def test_jnp_store_file_from_the_reference(tmp_path, stacks, codec):
    """A store the reference built and saved on its ``"jnp"`` backend
    loads in the port; its payload and decode are the reference's
    bitwise, and its reconstruction within one rounding (the reference
    fuses base + level·scale into an FMA on that backend)."""
    full = stacks[0]
    want = JDeltaStore.build(full, assignment=GROUPS, codec=codec,
                             seed=SEED, backend="jnp")
    path = str(tmp_path / "jnp.msgpack")
    want.save(path)
    got = DeltaStore.load(path, device="cpu")
    assert got.backend == "jnp" and got.codec.spec == want.codec.spec
    for name, v in want.payload.items():
        _same(got.payload[name], v)
    _same(got.codec.decode(got.payload, d=got.d),
          want.codec.decode(want.payload, backend="jnp", d=want.d))
    np.testing.assert_allclose(got.params_flat().numpy(),
                               np.asarray(want.params_flat()), rtol=1e-6,
                               atol=1e-7)
    mine = str(tmp_path / "mine.msgpack")
    got.save(mine)
    assert checkpoint.restore(mine, device="cpu")["backend"] == "jnp"


def test_store_refusals(tmp_path, stacks, stores):
    full = stacks[0]
    # a file of the reference's "jnp" codec path (the mesh placement's)
    # loads; an unknown backend is refused
    path = str(tmp_path / "s.msgpack")
    stores["identity", "coarse"][0].save(path)
    tree = checkpoint.restore(path, device="cpu")
    assert tree["backend"] == "pallas"
    tree["backend"] = "jnp"
    checkpoint.save(path, tree)
    assert DeltaStore.load(path, device="cpu").backend == "jnp"
    tree["backend"] = "triton"
    checkpoint.save(path, tree)
    with pytest.raises(ValueError, match="unknown codec backend"):
        DeltaStore.load(path, device="cpu")
    with pytest.raises(ValueError, match="assignment must be"):
        DeltaStore.build(full, assignment=[0, 1], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DeltaStore.build(full, codec="identity")


# ---------------------------------------------------------------------------
# from_history on small port runs


@pytest.fixture(scope="module")
def port_runs():
    fed = scenario_label_shift(0, n=240, m=4, device="cpu")
    fl = FLConfig(rounds=2, local_steps=1, batch_size=16, eval_every=2)
    init = lambda g: lenet.init_params(g, TNARROW, device="cpu")
    run = lambda spec, **kw: run_federated(spec, fed, fl=fl, model_init=init,
                                           device="cpu", **kw)
    return {spec: run(spec, keep_state=True)
            for spec in ("ucfl_k2", "fedavg", "local")}, run


@pytest.mark.parametrize("codec", CODECS)
def test_serve_parity_mesh(port_runs, codec):
    """`ServeEngine(placement=MeshShardMap(...))` on the store of a mesh
    run (one rank): `check_parity` holds, and the batch is the `HostVmap`
    batch bitwise (the reference's `test_serve_parity_mesh`)."""
    _, run = port_runs
    mesh = MeshShardMap(schedule="shard_map_streams", device="cpu")
    h = run("ucfl_k2", keep_state=True, placement=mesh)
    store = DeltaStore.from_history(h, codec=codec, device="cpu")
    eng = ServeEngine(store, apply_one, placement=mesh, max_batch=4)
    fed = scenario_label_shift(0, n=240, m=4, device="cpu")
    users = [1, 3, 0, 2]
    xs = fed.x_val[users, 0]
    check_parity(eng, users, xs)
    host = ServeEngine(store, apply_one, max_batch=4)
    assert torch.equal(eng.serve(users, xs), host.serve(users, xs))
    for u, x in zip(users, xs):
        eng.submit(u, x)
    out = eng.flush()
    assert len(out) == 4 and eng.last_stats["batches"] == 1


def test_from_history_assignments(port_runs):
    hists, run = port_runs
    h = hists["ucfl_k2"]
    store = DeltaStore.from_history(h, codec="identity", device="cpu")
    assert store.k == 2
    np.testing.assert_array_equal(store.assignment, h.extras.assignment)
    _same(store.params_flat(), stacked_ravel(h.final_params))
    assert DeltaStore.from_history(hists["fedavg"], device="cpu").k == 1
    assert DeltaStore.from_history(hists["local"], device="cpu").k == 4
    q = DeltaStore.from_history(h, codec="qsgd:4", device="cpu")
    _same(q.params_flat(), stacked_ravel(h.final_params))  # zero deltas
    with pytest.raises(ValueError, match="keep_state"):
        DeltaStore.from_history(run("fedavg"), device="cpu")


# ---------------------------------------------------------------------------
# ServeEngine


@pytest.mark.parametrize("codec", CODECS)
def test_served_logits_match_reference(stacks, stores, codec):
    xs = stacks[2]
    got, want = stores[codec, "coarse"]
    users = [2, 0, 5, 1, 4]
    jout = np.asarray(JServeEngine(want, japply_one).serve(
        users, xs[users]))
    out = ServeEngine(got, apply_one).serve(users, xs[users]).numpy()
    assert out.shape == jout.shape == (5, 47)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(1), jout.argmax(1))


@pytest.mark.parametrize("mode", ["coarse", "dedup"])
@pytest.mark.parametrize("codec", CODECS)
def test_check_parity_holds_and_catches_a_wrong_row(stacks, stores, codec,
                                                    mode):
    xs = stacks[2]
    store = stores[codec, mode][0]
    eng = ServeEngine(store, apply_one, max_batch=4)
    users = [3, 0, 2, 1, 5]
    served = eng.serve(users, xs[users])
    # both decode paths run the same kernels: the port's are bitwise
    ref = eng.forward(store.params(users), _t(xs[users]))
    _same(served, ref)
    assert check_parity(eng, users, xs[users]) == float(served.abs().max())
    bad = served.clone()
    bad[2] += 1.0
    with pytest.raises(RuntimeError, match="parity anchor violated"):
        check_parity(eng, users, xs[users], served=bad)


def test_identity_serves_true_trained_params(stacks, stores):
    full, _, xs = stacks
    store = stores["identity", "coarse"][0]
    eng = ServeEngine(store, apply_one)
    users = list(range(M))
    _same(eng.serve(users, xs), eng.forward(_tree(full), _t(xs)))


@pytest.mark.parametrize("codec", CODECS)
def test_microbatcher_submit_order_and_chunking(stacks, stores, codec):
    xs = stacks[2]
    eng = ServeEngine(stores[codec, "coarse"][0], apply_one, max_batch=2)
    users = [2, 0, 3, 1, 2]
    tickets = [eng.submit(u, xs[u]) for u in users]
    outs = eng.flush()
    assert tickets == [0, 1, 2, 3, 4]
    assert eng.last_stats["requests"] == 5
    assert eng.last_stats["batches"] == 3          # ceil(5 / max_batch=2)
    assert len(eng.last_stats["latency_s"]) == 3
    for i, u in enumerate(users):
        # the contract bitwise: a request served in a batch of 2 equals
        # it served alone
        one = eng.serve([u], xs[u][None]).numpy()[0]
        _same(outs[i], one)
    assert eng.flush() == [] and eng.last_stats["batches"] == 0
    # tensors are taken as they are, and the tickets restart
    assert eng.submit(4, _t(xs[4])) == 0
    _same(eng.flush()[0], eng.serve([4], xs[4][None]).numpy()[0])


def test_engine_refusals(stores):
    store = stores["identity", "coarse"][0]
    with pytest.raises(ValueError, match="max_batch"):
        ServeEngine(store, apply_one, max_batch=0)
    # --federated trains an LM population and serves it per user
    # (tests/test_torch_serve_lm.py holds it against the reference)
    outs = serve_cli.main(["--federated", "--device", "cpu", "--arch",
                           "gemma2-27b", "--rounds", "1", "--clients", "2",
                           "--pool", "5", "--requests", "3", "--tokens", "2",
                           "--prompt-len", "8", "--max-batch", "2"])
    assert [o.shape for o in outs] == [(2,)] * 3
    assert np.array_equal(outs[0], outs[2])       # user 0, twice


# ---------------------------------------------------------------------------
# files


@pytest.mark.parametrize("codec", CODECS)
def test_store_files_match_reference_byte_for_byte(tmp_path, stacks, stores,
                                                   codec):
    xs = stacks[2]
    got, want = stores[codec, "coarse"]
    mine = str(tmp_path / "port.msgpack")
    theirs = str(tmp_path / "ref.msgpack")
    got.save(mine)
    want.save(theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    users = [1, 4, 5]
    # each package loads the other's file and serves it bitwise
    loaded = DeltaStore.load(theirs, device="cpu")
    assert loaded.codec.spec == got.codec.spec and loaded.seed == SEED
    _same(loaded.bits.delta_bits, got.bits.delta_bits)
    _same(loaded.params_flat(), got.params_flat())
    _same(ServeEngine(loaded, apply_one).serve(users, xs[users]),
          ServeEngine(got, apply_one).serve(users, xs[users]))
    jloaded = JDeltaStore.load(mine)
    _same(np.asarray(JServeEngine(jloaded, japply_one).serve(
        users, xs[users])),
        np.asarray(JServeEngine(want, japply_one).serve(users, xs[users])))


def test_store_load_refuses_unknown_version(tmp_path, stores):
    got = stores["qsgd:4", "coarse"][0]
    path = str(tmp_path / "s.msgpack")
    got.save(path)
    tree = checkpoint.restore(path, device="cpu")
    tree["version"] = 2
    checkpoint.save(path, tree)
    with pytest.raises(ValueError, match="unknown DeltaStore version 2"):
        DeltaStore.load(path, device="cpu")
    with pytest.raises(ValueError, match="version"):
        JDeltaStore.load(path)
    assert os.path.exists(path) and jckpt.restore(path)["version"] == 2


# ---------------------------------------------------------------------------
# item 3: the rest of the core API


KEY = jax.random.PRNGKey(0)


def _np(a):
    return np.asarray(a)


def test_fedavg_aggregate_and_downlink_models():
    m = 6
    jparams = {"a": jax.random.normal(KEY, (m, 3, 4)),
               "b": jax.random.normal(jax.random.PRNGKey(1), (m, 5))}
    jn = jnp.asarray([10.0, 20.0, 5.0, 40.0, 15.0, 10.0])
    want = JC.fedavg_aggregate(jparams, jn)
    got = C.fedavg_aggregate({k: _t(v) for k, v in jparams.items()}, _t(jn))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-6)
        assert torch.equal(got[k][0], got[k][m - 1])    # one model for all
    w = jax.nn.softmax(jax.random.normal(KEY, (10, 10)), axis=1)
    jplan = JC.kmeans(w, 3, key=KEY)
    plan = C.StreamPlan(_t(jplan.centroids), _t(jplan.assignment).long(),
                        _t(jplan.inertia))
    assert C.downlink_models(plan) == JC.downlink_models(jplan) == 3
    assert C.downlink_models(_t(w)) == JC.downlink_models(w) == 10


def test_similarity_round_matches_reference():
    def jloss(p, data):
        return jnp.mean((data["x"] @ p["w"] - data["y"]) ** 2)

    def loss(p, data):
        return torch.mean((data["x"] @ p["w"] - data["y"]) ** 2)

    ks = jax.random.split(KEY, 6)
    jdata = [{"x": jax.random.normal(ks[i], (20 + i, 5)),
              "y": jax.random.normal(ks[i + 3], (20 + i,))}
             for i in range(3)]
    data = [{k: _t(v) for k, v in d.items()} for d in jdata]
    jp = {"w": jnp.linspace(-1.0, 1.0, 5)}
    p = {"w": _t(jp["w"])}
    want = JC.similarity_round(jloss, jp, jdata)
    got = C.similarity_round(loss, p, data)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=1e-4)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    np.testing.assert_allclose(
        C.client_gradients(loss, p, data).numpy(),
        _np(JC.client_gradients(jloss, jp, jdata)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        C.sigma_estimates(loss, p, data, n_batches=3).numpy(),
        _np(JC.sigma_estimates(jloss, jp, jdata, n_batches=3)), rtol=1e-4)


def test_effective_samples_matches_reference():
    w = jax.nn.softmax(jax.random.normal(KEY, (7, 7)), axis=1)
    n = jnp.asarray([0.5, 3.0, 10.0, 100.0, 7.0, 1.0, 20.0])
    np.testing.assert_allclose(C.effective_samples(_t(w), _t(n)).numpy(),
                               _np(JC.effective_samples(w, n)), rtol=1e-6)


def _cluster_rows():
    key = jax.random.PRNGKey(1)
    c0 = jax.random.normal(key, (6, 8)) * 0.05 + 5
    c1 = jax.random.normal(key, (6, 8)) * 0.05 - 5
    return jnp.concatenate([c0, c1])


@pytest.mark.parametrize("case", ["two", "singleton", "empty"])
def test_silhouette_score_matches_reference(case):
    rows = _cluster_rows()
    asn = np.repeat([0, 1], 6)
    k = 2
    if case == "singleton":
        asn[3] = 2                # a one-member cluster scores 0
        k = 3
    if case == "empty":
        k = 4                     # clusters 2 and 3 hold nobody
        asn[0] = 3
    want = JC.silhouette_score(rows, jnp.asarray(asn, jnp.int32), k)
    got = C.silhouette_score(_t(rows), torch.from_numpy(asn), k)
    # atol 1e-3: the distances come from the Gram form |a|² + |b|² − 2a·b
    # in f32, whose cancellation leaves ~sqrt(eps·|x|²) ≈ 5e-3 of rounding
    # in a near-zero distance, different in each package's matmul
    np.testing.assert_allclose(float(got), float(want), atol=1e-3)


def test_select_num_streams_matches_reference():
    jw = jax.nn.softmax(3.0 * jax.random.normal(KEY, (12, 12)), axis=1)
    for key in (jax.random.PRNGKey(5),):
        best, scores = JC.select_num_streams(jw, key=key)
        first = int(jax.random.randint(key, (), 0, 12))
        got_best, got_scores = C.select_num_streams(
            _t(jw), first=[first] * len(scores))
        assert list(got_scores) == list(scores) == [2, 3, 4, 6, 8]
        # atol 1e-3, as for silhouette_score (the Gram-form distances)
        np.testing.assert_allclose(list(got_scores.values()),
                                   list(scores.values()), atol=1e-3)
        assert got_best == best
    b, s = C.select_num_streams(_t(jw), [2, 3],
                                first=torch.Generator().manual_seed(1))
    assert b in (2, 3) and list(s) == [2, 3]
    with pytest.raises(ValueError, match="first centres"):
        C.select_num_streams(_t(jw), [2, 3], first=[0])


def test_theory_matches_reference():
    m = 6
    key = jax.random.PRNGKey(3)
    disc = jnp.abs(jax.random.normal(key, (m, m)))
    disc = (disc + disc.T) * (1 - jnp.eye(m)) * 0.05
    n = jax.random.randint(key, (m,), 10, 200).astype(jnp.float32)
    w = JC.mixing_matrix(disc, jnp.ones((m,)), n)
    from repro.core import theory as jth
    from repro_torch.core import theory as th
    for name in ("estimation_term", "theorem1_bound"):
        np.testing.assert_allclose(
            getattr(th, name)(_t(w), _t(n), **({"disc": _t(disc)}
                                              if name != "estimation_term"
                                              else {})).numpy(),
            _np(getattr(jth, name)(w, n, **({"disc": disc}
                                          if name != "estimation_term"
                                          else {}))), rtol=1e-5)
    np.testing.assert_allclose(th.bias_term(_t(w), _t(disc)).numpy(),
                               _np(jth.bias_term(w, disc)), rtol=1e-5)
    np.testing.assert_allclose(
        C.theorem1_bound(_t(w), _t(n), _t(disc), lam=0.1, B=2.0).numpy(),
        _np(JC.theorem1_bound(w, n, disc, lam=0.1, B=2.0)), rtol=1e-5)
    w_star, b_star = C.bound_minimizing_weights(_t(n), _t(disc), steps=300)
    jw_star, jb_star = JC.bound_minimizing_weights(n, disc, steps=300)
    np.testing.assert_allclose(w_star.numpy(), _np(jw_star), atol=1e-4)
    np.testing.assert_allclose(b_star.numpy(), _np(jb_star), rtol=1e-4)
    np.testing.assert_allclose(w_star.sum(1).numpy(), 1.0, atol=1e-6)
