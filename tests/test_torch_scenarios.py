"""The port's scenario generators against the reference, on the CPU.

`rotate_images` bitwise `jnp.rot90`; each of the three `SCENARIOS` on
the reference's ``synthetic_*`` arrays (passed as ``data``) bitwise the
reference's `FederatedData` (the numpy partitions, the padding rule, the
rotations and the label permutations); `synthetic_lm_tokens` bitwise on
the reference's draws (a, start, noise, rand), at vocab 50,304 too,
where the Markov rule's int32 arithmetic wraps.  torch's generator does
not reproduce threefry, so the port's own draws (`synthetic_cifar`, the
tokens) are held at the distribution level: shapes, ranges, class
balance, the 10 % noise rate.  Then the reference's own data tests
(`tests/test_fl.py`) and the paper's two §8 claims
(`tests/test_system.py`, ``slow`` there and here) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro_torch.data import (SCENARIOS, rotate_images,
                              scenario_concept_shift,
                              scenario_covariate_shift, scenario_label_shift,
                              synthetic_cifar, synthetic_emnist,
                              synthetic_lm_tokens)
from repro_torch.fl import FLConfig, run_federated

KEY = jax.random.PRNGKey(0)


def test_rotate_images_matches_reference():
    x = np.random.default_rng(0).standard_normal(
        (3, 2, 5, 5, 3)).astype(np.float32)
    for k in (-1, 0, 1, 2, 3, 5):
        want = np.asarray(jfed.rotate_images(jnp.asarray(x), k))
        got = rotate_images(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)


SIZES = {"emnist_label_shift": (jsyn.synthetic_emnist, dict(n=700, m=6)),
         "emnist_covariate_shift": (jsyn.synthetic_emnist,
                                    dict(n=900, m=8, n_groups=4)),
         "cifar_concept_shift": (jsyn.synthetic_cifar,
                                 dict(n=600, m=8, n_groups=3))}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_on_given_data_match_reference(name):
    """The reference's base arrays in, its `FederatedData` out, bitwise."""
    assert sorted(SCENARIOS) == sorted(jfed.SCENARIOS)
    syn, kw = SIZES[name]
    key = jax.random.PRNGKey(5)
    want = jfed.SCENARIOS[name](key, **kw)
    base = {k: np.asarray(v) for k, v in syn(key, kw["n"]).items()}
    got = SCENARIOS[name](data=base, device="cpu", **kw)
    for field in want._fields:
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert got.y.dtype == torch.int64 and got.x.dtype == torch.float32


@pytest.mark.parametrize("vocab", [97, 50304])
def test_lm_tokens_on_given_draws_match_reference(vocab):
    key = jax.random.PRNGKey(vocab)
    b, s = 3, 40
    want = np.asarray(jsyn.synthetic_lm_tokens(key, b, s, vocab))
    # the reference's draws, from its own keys
    k0, kf, kn = jax.random.split(key, 3)
    draws = dict(
        a=jax.random.randint(kf, (2,), 1, vocab - 1),
        start=jax.random.randint(k0, (b, 2), 0, vocab),
        noise=jax.random.bernoulli(kn, 0.1, (b, s)),
        rand=jax.random.randint(kn, (b, s), 0, vocab))
    got = synthetic_lm_tokens(None, b, s, vocab, **{
        k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_draws_distributions():
    gen = torch.Generator().manual_seed(0)
    d = synthetic_cifar(gen, 2000)
    assert d["x"].shape == (2000, 32, 32, 3) and d["x"].dtype == torch.float32
    counts = torch.bincount(d["y"], minlength=10)
    assert counts.numel() == 10 and int(counts.min()) > 150
    want = jsyn.synthetic_cifar(KEY, 2000)["x"]
    # the same construction: per-pixel spread within 10 % of the
    # reference's draw
    assert abs(float(d["x"].std()) / float(jnp.std(want)) - 1) < 0.1
    toks = synthetic_lm_tokens(gen, 64, 200, 97)
    assert toks.shape == (64, 200) and toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < 97
    # about 90 % of tokens follow the order-2 rule of some a (the rule is
    # unknown here: read it off as the most frequent successor)
    pairs = torch.stack([toks[:, :-2], toks[:, 1:-1], toks[:, 2:]], -1)
    flat = pairs.reshape(-1, 3).tolist()
    best = {}
    for a, b, c in flat:
        best.setdefault((a, b), {}).setdefault(c, 0)
        best[(a, b)][c] += 1
    follow = sum(max(v.values()) for v in best.values()) / len(flat)
    assert follow > 0.8
    e = synthetic_emnist(gen, 100)
    assert e["x"].shape == (100, 28, 28, 1) and int(e["y"].max()) < 47


# ---------------------------------------------------------------------------
# the reference's data tests (tests/test_fl.py), on the port's own draws


def test_lm_tokens_learnable_structure():
    toks = synthetic_lm_tokens(torch.Generator().manual_seed(0), 4, 128, 97)
    assert toks.shape == (4, 128)
    assert int(toks.max()) < 97
    assert len(np.unique(toks.numpy())) > 5


def test_label_shift_partition_heterogeneous():
    fed = scenario_label_shift(0, n=600, m=6, device="cpu")
    assert fed.x.shape[0] == 6
    h = [np.bincount(fed.y[i].numpy(), minlength=47) for i in range(6)]
    assert np.corrcoef(np.stack(h)).min() < 0.9


def test_covariate_shift_groups_rotate():
    fed = scenario_covariate_shift(0, n=800, m=8, device="cpu")
    assert set(fed.group.tolist()) == {0, 1, 2, 3}
    base = scenario_label_shift(0, n=800, m=8, seed=1, device="cpu")
    for i in range(8):
        assert torch.equal(fed.x[i], rotate_images(base.x[i], i % 4))
        assert torch.equal(fed.y[i], base.y[i])


def test_concept_shift_permutes_labels():
    fed = scenario_concept_shift(0, n=600, m=8, device="cpu")
    assert fed.x.shape[-1] == 3
    assert set(fed.group.tolist()) == {0, 1, 2, 3}
    # an IID round-robin split: every client's sizes within one sample
    assert int(fed.n.max() - fed.n.min()) <= 1
    # images that name their own index: each client's labels are its base
    # labels through one permutation per group, and the groups' differ
    n = 600
    y = np.random.default_rng(3).integers(0, 10, n)
    x = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None, None],
                        (n, 2, 2, 3))
    fed = scenario_concept_shift(data={"x": x, "y": y}, n=n, m=8,
                                 device="cpu")
    maps = {}
    for i in range(8):
        src = y[fed.x[i, :, 0, 0, 0].long().numpy()]
        g = int(fed.group[i])
        for a, b in zip(src, fed.y[i].numpy()):
            assert maps.setdefault((g, int(a)), int(b)) == int(b)
    perms = {g: tuple(maps[(g, c)] for c in range(10)) for g in range(4)}
    assert all(sorted(p) == list(range(10)) for p in perms.values())
    assert len(set(perms.values())) == 4


def test_scenarios_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        scenario_concept_shift(0, n=100, m=2)


# ---------------------------------------------------------------------------
# the paper's §8 claims (tests/test_system.py), on the port


@pytest.mark.slow
def test_concept_shift_orderings():
    """Under concept shift conflicting tasks hurt FedAvg, the oracle
    recovers, and UCFL is never worse than FedAvg (the Eq. 6 fallback)."""
    fed = scenario_concept_shift(0, n=1500, m=8, n_groups=2, device="cpu")
    fl = FLConfig(rounds=12, local_steps=5, batch_size=32, eval_every=11)
    acc = {alg: run_federated(alg, fed, fl=fl, device="cpu").mean_acc[-1]
           for alg in ["fedavg", "local", "ucfl_k2", "oracle"]}
    assert acc["local"] > acc["fedavg"]
    assert acc["ucfl_k2"] >= acc["fedavg"] - 5e-3
    assert acc["oracle"] > acc["fedavg"]


@pytest.mark.slow
def test_label_shift_collaboration_helps():
    fed = scenario_label_shift(0, n=1200, m=8, device="cpu")
    fl = FLConfig(rounds=12, local_steps=5, batch_size=32, eval_every=11)
    acc = {alg: run_federated(alg, fed, fl=fl, device="cpu").mean_acc[-1]
           for alg in ["fedavg", "local", "ucfl"]}
    assert acc["fedavg"] > acc["local"]
    assert acc["ucfl"] >= acc["local"]
