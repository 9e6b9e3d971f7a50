"""Per-user LM serving (`launch.serve --federated`) against the reference.

One module fixture runs the reference's federated LM training once
(ucfl_k2 over 4 clients, stablelm-3b's family cut to 1 layer, d_model 64,
vocab 128), builds its `DeltaStore`s (identity and qsgd:4) with
`from_history`, and serves 4 users through its `ServeEngine` over
`build_decode_one` under `jax.vmap`.  The port builds its stores from the
same final params, assignment and rounding noise and serves the same
prompts through its own `ServeEngine` over its `build_decode_one` under
`torch.func.vmap`.  Held: the served tokens equal; the logits within
2e-4 (tests/test_torch_lm.py's); `check_parity` on both stores on
`HostVmap` and `MeshShardMap`; the store files byte for byte, each
package loading the other's; the vmapped flash op bitwise per-user calls;
the vmapped decode (a ring that wraps, a MoE layer) against per-user
`generate`; and the two CLIs, ``--federated --store``, on one file with
the reference's prompts: the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.fl import FLConfig as JFLConfig
from repro.fl import run_federated as j_run
from repro.fl.serve import DeltaStore as JDeltaStore
from repro.fl.serve import ServeEngine as JServeEngine
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import lm_view_from_numpy
from repro_torch.fl import (DeltaStore, HostVmap, MeshShardMap, ServeEngine,
                            check_parity)
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import scan
from repro_torch.models import transformer as T

ARCH = "stablelm-3b"
TINY = dict(n_layers=1, d_model=64, vocab=128, max_seq=64)
M, SEED = 4, 0
P, N = 8, 4                   # prompt length, served tokens
CACHE = P + N
USERS = [2, 0, 3, 1]
CODECS = ["identity", "qsgd:4"]
TOL = 2e-4


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jlogits_fn(cfg):
    """The reference's per-user decode with its logits kept: the steps of
    its `build_decode_one`, each token fed back as it was served."""
    def one(params, tokens, served):
        caches = jscan.stack_caches(
            jT.make_caches(cfg, 1, CACHE, jnp.float32), cfg)
        logits, caches = jscan.prefill(params, cfg, {"tokens": tokens[None]},
                                       caches)
        out = [logits[0, -1]]
        for i in range(N - 1):
            pos = jnp.full((1,), P + i, jnp.int32)
            logits, caches = jscan.decode_step(params, cfg,
                                               served[None, i:i + 1], caches,
                                               pos)
            out.append(logits[0, -1])
        return jnp.stack(out)
    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jcfg = jreduced(jget_config(ARCH), **TINY)
    pcfg = configs.reduced(configs.get_config(ARCH), **TINY)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jfed = jtrain.lm_federated_data(jax.random.PRNGKey(3), M, pool=6,
                                    n_val=2, seq=P, vocab=jcfg.vocab_size)
    lm_loss = jsteps._loss_fn(jcfg, remat=False)
    h = j_run("ucfl_k2", jfed,
              fl=JFLConfig(rounds=1, local_steps=1, batch_size=2,
                           eval_every=1, sigma_batches=2),
              model_init=lambda k: jsteps.init_model_params(k, jcfg),
              loss_fn=lambda p, b: lm_loss(p, {"tokens": b["x"]}),
              acc_fn=lambda p, b: -lm_loss(p, {"tokens": b["x"]})[0],
              keep_state=True, superstep=False, seed=SEED)
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (M, P)).astype(np.int32)
    jdecode = jserve.build_decode_one(jcfg, P, N, CACHE)
    path = tmp_path_factory.mktemp("lmstore")
    out = {"jcfg": jcfg, "pcfg": pcfg, "h": h, "prompts": prompts,
           "path": path}
    eng = None
    for codec in CODECS:
        store = JDeltaStore.from_history(h, codec=codec, seed=SEED)
        if eng is None:
            eng = JServeEngine(store, jdecode, max_batch=4)
            for u in USERS:
                eng.submit(u, prompts[u])
            served = np.stack(eng.flush())
        else:
            # the engine's compiled vmapped decode, on this store's
            # reconstruction of the same users
            served = np.asarray(eng.forward(store.params(USERS),
                                            prompts[USERS]))
        store.save(str(path / f"want-{codec}.msgpack"))
        out[codec] = (store, served)
    out["logits"] = np.asarray(_jlogits_fn(jcfg)(
        out["identity"][0].params(USERS), jnp.asarray(prompts[USERS]),
        jnp.asarray(out["identity"][1])))
    return out


def _plogits_fn(cfg, prompt_len, n, cache_len):
    """The port's per-user decode with its logits kept, each token fed
    back as it was served: `build_decode_one`'s steps, to run under
    `torch.func.vmap`."""
    def one(params, tokens, served):
        p = scan.unstack_layer_params(scan.nest_params(params), cfg)
        caches = T.make_caches(cfg, 1, cache_len, cfg.cdtype, device="cpu")
        logits, caches = T.prefill(p, cfg, {"tokens": tokens[None]}, caches)
        out = [logits[0, -1]]
        for i in range(n - 1):
            logits, caches = T.decode_step(p, cfg, served[None, i:i + 1],
                                           caches, prompt_len + i)
            out.append(logits[0, -1])
        return torch.stack(out)
    return vmap(one)


def _store(ref, codec, backend="pallas"):
    """The port's store of the reference run's final params, its
    assignment and (qsgd) its rounding noise."""
    h = ref["h"]
    flat = lm_view_from_numpy(_jtree(h.final_params), "cpu")
    d = sum(int(np.prod(v.shape[1:])) for v in flat.values())
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(SEED), (M, d),
                                          jnp.float32))
    return DeltaStore.build(flat, assignment=h.extras.assignment,
                            codec=codec, seed=SEED, noise=noise,
                            backend=backend, device="cpu")


def _engine(ref, store, placement=None):
    decode = serve.build_decode_one(ref["pcfg"], P, N, CACHE)
    return ServeEngine(store, decode, placement=placement, max_batch=4)


def _prompts(ref, users=USERS):
    return torch.from_numpy(ref["prompts"][users]).long()


# ---------------------------------------------------------------------------
# served tokens and logits


@pytest.mark.parametrize("codec", CODECS)
def test_served_tokens_match_reference(ref, codec):
    eng = _engine(ref, _store(ref, codec))
    for u in USERS:
        eng.submit(u, _prompts(ref, [u])[0])
    got = np.stack(eng.flush())
    assert got.dtype == np.int32 and got.shape == (len(USERS), N)
    np.testing.assert_array_equal(got, ref[codec][1])
    assert eng.last_stats["batches"] == 1


def test_served_logits_match_reference(ref):
    """The logits behind the served tokens: the engine's gathered params,
    the port's decode steps under vmap, against the reference's."""
    eng = _engine(ref, _store(ref, "identity"))
    served = torch.from_numpy(ref["identity"][1]).long()
    logits = _plogits_fn(ref["pcfg"], P, N, CACHE)(
        eng.params_for(USERS), _prompts(ref), served)
    np.testing.assert_allclose(_np(logits), ref["logits"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  ref["identity"][1])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("where", ["host", "mesh"])
def test_check_parity(ref, codec, where):
    placement = (MeshShardMap(schedule="shard_map_streams", device="cpu")
                 if where == "mesh" else HostVmap())
    store = _store(ref, codec, backend=placement.codec_backend)
    eng = _engine(ref, store, placement)
    check_parity(eng, USERS, _prompts(ref))
    np.testing.assert_array_equal(eng.serve(USERS, _prompts(ref)).numpy(),
                                  ref[codec][1])


# ---------------------------------------------------------------------------
# store files


@pytest.mark.parametrize("codec", CODECS)
def test_store_files_match_reference_byte_for_byte(ref, codec):
    path = ref["path"]
    want = path / f"want-{codec}.msgpack"
    got = path / f"got-{codec}.msgpack"
    store = _store(ref, codec)
    assert sorted(store.template) == sorted(scan.flat_params(
        _jtree(ref[codec][0].template)))
    store.save(str(got))
    assert got.read_bytes() == want.read_bytes()
    loaded = DeltaStore.load(str(want), device="cpu")
    assert loaded.template.keys() == store.template.keys()
    assert torch.equal(loaded.params_flat(), store.params_flat())
    assert loaded.summary() == store.summary() == ref[codec][0].summary()
    back = JDeltaStore.load(str(got))
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  store.params_flat().numpy())


# ---------------------------------------------------------------------------
# the flash op and the cached path under vmap


@pytest.mark.parametrize("sq,sk,window,cap", [(12, 12, None, None),
                                              (1, 20, 8, 30.0)])
def test_vmapped_flash_op_equals_per_user_calls(sq, sk, window, cap):
    gen = torch.Generator().manual_seed(sq)
    u, h, kh, hd = 3, 4, 2, 16
    q = torch.randn((u, 1, h, sq, hd), generator=gen)
    k = torch.randn((u, 1, kh, sk, hd), generator=gen)
    v = torch.randn((u, 1, kh, sk, hd), generator=gen)
    kw = dict(window=window, softcap=cap)
    got = vmap(lambda a, b, c: ops.flash_attention(a, b, c, **kw))(q, k, v)
    for i in range(u):
        assert torch.equal(got[i], ops.flash_attention(q[i], k[i], v[i],
                                                       **kw))
    # an unbatched argument (one user's keys for all) broadcasts
    one = vmap(lambda a: ops.flash_attention(a, k[0], v[0], **kw))(q)
    assert torch.equal(one[2], ops.flash_attention(q[2], k[0], v[0], **kw))


@pytest.mark.parametrize("arch,prompt", [("gemma2-27b", 72),
                                         ("olmoe-1b-7b", 10)])
def test_vmapped_decode_equals_per_user_generate(arch, prompt):
    """The per-user decode under vmap (rings made inside the vmapped
    function, written out of place once) against `generate` per user:
    gemma2's local ring (window 64) taking a 72-token prompt, and a MoE
    layer whose groups are each user's own tokens."""
    cfg = configs.reduced(configs.get_config(arch), **TINY)
    if arch == "gemma2-27b":
        assert cfg.attn_window(0) == 64 < prompt
    params = scan.stack_layer_params(T.init_params(
        torch.Generator().manual_seed(1), cfg, device="cpu"), cfg)
    flat = scan.flat_params(params)
    gen = torch.Generator().manual_seed(2)
    stacked = {k: v[None] + 0.01 * torch.randn((3,) + v.shape, generator=gen)
               for k, v in flat.items()}
    prompts = torch.randint(0, cfg.vocab_size, (3, prompt), generator=gen)
    n, clen = 5, prompt + 5
    toks = vmap(serve.build_decode_one(cfg, prompt, n, clen))(stacked,
                                                               prompts)
    logits = _plogits_fn(cfg, prompt, n, clen)(stacked, prompts, toks.long())
    for i in range(3):
        mine = scan.unstack_layer_params(scan.nest_params(
            {k: v[i] for k, v in stacked.items()}), cfg)
        res = serve.generate(mine, cfg, prompts[i:i + 1], n, clen,
                             return_logits=True)
        np.testing.assert_array_equal(toks[i].numpy(), res.tokens[0].numpy())
        np.testing.assert_allclose(_np(logits[i]),
                                   _np(torch.cat(res.logits)), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the CLI


def test_federated_cli_matches_reference_cli(tmp_path, capsys):
    """``--federated --store``: the reference's CLI and the port's serve one
    store file (the reference's, at the cpu-small preset) with the
    reference's per-user prompts, and print the same served tokens."""
    jcfg = jtrain.preset_config(ARCH, "cpu-small")
    params = jsteps.init_model_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(6)
    stacked = jax.tree_util.tree_map(
        lambda l: (np.asarray(l)[None] + 0.02 * rng.standard_normal(
            (3,) + l.shape)).astype(np.float32), params)
    path = str(tmp_path / "store.msgpack")
    JDeltaStore.build(stacked, assignment=[0, 0, 1]).save(path)
    argv = ["--federated", "--arch", ARCH, "--store", path, "--requests",
            "4", "--tokens", "3", "--prompt-len", "6", "--max-batch", "4",
            "--seed", "1"]
    want = jserve.main(argv)
    want_text = capsys.readouterr().out
    kreq = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    prompts = {u: np.asarray(jax.random.randint(
        jax.random.fold_in(kreq, u), (6,), 0, jcfg.vocab_size,
        dtype=jnp.int32)) for u in range(3)}
    got = serve.main(argv + ["--device", "cpu"], prompts=prompts)
    got_text = capsys.readouterr().out
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    lines = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if ln.startswith(("loaded store", "user "))]
    assert lines(got_text) == lines(want_text)
    assert "parity anchor OK" in got_text


def test_federated_cli_trains_saves_and_reloads(tmp_path, capsys):
    """The port's CLI at its smallest flags on the mesh placement with a
    qsgd:4 store, saved; served again from the saved file: the same
    tokens."""
    path = str(tmp_path / "store.msgpack")
    small = ["--federated", "--device", "cpu", "--arch", ARCH, "--requests",
             "5", "--tokens", "3", "--prompt-len", "8", "--max-batch", "2"]
    outs = serve.main(small + ["--rounds", "1", "--clients", "2", "--pool",
                               "5", "--codec", "qsgd:4", "--placement",
                               "mesh", "--save-store", path])
    text = capsys.readouterr().out
    assert "store[qsgd:4]" in text and "parity anchor OK" in text
    again = serve.main(small + ["--store", path])
    assert len(outs) == 5 and all(o.shape == (3,) for o in outs)
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    stored = DeltaStore.load(path, device="cpu")
    assert stored.backend == "jnp" and stored.m == 2
