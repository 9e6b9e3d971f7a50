"""The port's checkpoint format against the reference's, on the CPU.

`repro_torch.checkpoint._msgpack.packb` must give the bytes of
``msgpack.packb(use_bin_type=True)`` at every size boundary of every type
the format uses, and `unpackb` must read them back as ``msgpack.unpackb``
does.  A file either package's `save` writes, the other's `restore`
reads bitwise (f32, int32, bool and bf16 leaves, nested lists and dicts,
None, strings, LeNet-5 params).  Corrupt, legacy and paged files behave
as the reference's do.
"""
import os
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import checkpoint as jck
from repro.models import lenet as jlenet
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import _msgpack
from repro_torch.convert import tree_from_numpy, tree_to_numpy

INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**31 - 1,
             2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
             -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
             -2**31 + 1, -2**31, -2**31 - 1, -2**32, -2**63 + 1, -2**63]
LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_bytes(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = _msgpack.packb(obj)
    assert got == want, (obj if len(repr(obj)) < 200 else type(obj))
    back = _msgpack.unpackb(want)
    assert back == msgpack.unpackb(want, raw=False, strict_map_key=False)
    return back


@pytest.mark.parametrize("v", INT_EDGES)
def test_packb_ints_match_msgpack(v):
    assert _same_bytes(v) == v
    assert _same_bytes([v, -v if -v >= -2**63 else 0]) is not None


@pytest.mark.parametrize("n", LEN_EDGES)
def test_packb_sizes_match_msgpack(n):
    """str, bin, array and map headers at each length boundary."""
    assert _same_bytes("x" * n) == "x" * n
    assert _same_bytes(b"\x07" * n) == b"\x07" * n
    if n <= 65536:
        assert _same_bytes(list(range(n % 300))) is not None
        assert _same_bytes([None] * n) == [None] * n
        tree = {f"k{i}": i for i in range(n)}
        assert _same_bytes(tree) == tree


def test_packb_scalars_and_nesting_match_msgpack():
    tree = {"none": None, "t": True, "f": False, "pi": 3.141592653589793,
            "neg": -0.0, "inf": float("inf"), "tiny": 5e-324,
            "uni": "αβγ ✓", "tuple": (1, 2.5, "x"), 7: "int key",
            "nested": [{"a": [[], {}, [b""]]}, b"\x00\xff" * 40]}
    back = _same_bytes(tree)
    assert back["tuple"] == [1, 2.5, "x"] and back[7] == "int key"


def test_unpackb_reads_float32_and_refuses_ext_and_damage():
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert f32[0] == 0xCA and _msgpack.unpackb(f32) == 1.5
    ext = msgpack.packb(msgpack.ExtType(5, b"abcd"))
    with pytest.raises(ValueError, match="ext"):
        _msgpack.unpackb(ext)
    blob = msgpack.packb({"a": [1, 2, 3], "b": b"xyz"}, use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(blob[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(blob + b"\x00")
    with pytest.raises(TypeError):
        _msgpack.packb(np.float32(1.0))


@settings(max_examples=60, deadline=None)
@given(st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40)
    | st.binary(max_size=300),
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60))
def test_packb_matches_msgpack_on_random_trees(tree):
    assert _msgpack.packb(tree) == msgpack.packb(tree, use_bin_type=True)
    assert _msgpack.unpackb(_msgpack.packb(tree)) == msgpack.unpackb(
        msgpack.packb(tree, use_bin_type=True), raw=False,
        strict_map_key=False)


def _tree():
    """One tree of every leaf kind the format carries, as numpy."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    return {
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32),
        "bool": rng.random((2, 2, 2)) < 0.5,
        "bf16": bf,
        "scalar": np.asarray(np.float32(2.5)),
        "layers": [{"w": rng.standard_normal((2, 2)).astype(np.float32),
                    "b": None}, {"w": np.zeros((0, 3), np.float32)}],
        "step": 123456, "lr": 0.1, "name": "run-α", "done": True,
        "empty": {}, "meta": {"nested": {"tag": "x", "n": -7}},
    }


def _assert_tree_equal(got, want):
    """``got`` (numpy leaves) bitwise ``want`` (numpy leaves)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


def _port_to_numpy(tree):
    """The port's restored tree with its tensors as numpy (bf16 through its
    bits, as ml_dtypes)."""
    if isinstance(tree, dict):
        return {k: _port_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return tree.numpy()
    return tree


def _map_arrays(fn, tree):
    """``fn`` on the numpy leaves, dict order kept (jax's tree_map sorts
    the keys, which would change the file's bytes)."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_arrays(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, np.ndarray) else tree


def _to_port(tree):
    return _map_arrays(lambda a: tree_from_numpy(a, "cpu"), tree)


def _to_jax(tree):
    return _map_arrays(jnp.asarray, tree)


def _from_jax(tree):
    if isinstance(tree, dict):
        return {k: _from_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_jax(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    want = _tree()
    jck.save(str(tmp_path / "ref.msgpack"), _to_jax(want))
    got = tck.restore(str(tmp_path / "ref.msgpack"), device="cpu")
    assert got["bf16"].dtype == torch.bfloat16
    _assert_tree_equal(_port_to_numpy(got), want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    want = _tree()
    path = str(tmp_path / "port.msgpack")
    tck.save(path, _to_port(want))
    _assert_tree_equal(_from_jax(jck.restore(path)), want)
    # the same tree saved by both packages gives the same file
    jck.save(str(tmp_path / "ref.msgpack"), _to_jax(want))
    with open(path, "rb") as a, open(tmp_path / "ref.msgpack", "rb") as b:
        assert a.read() == b.read()


def test_lenet_params_round_trip_both_ways(tmp_path):
    params = jax.tree_util.tree_map(np.asarray, jlenet.init_params(
        jax.random.PRNGKey(0), jlenet.LeNetConfig()))
    port = tree_from_numpy(params, "cpu")
    opt = {"mu": port, "step": torch.zeros(4, dtype=torch.int32)}
    tck.save_train_state(str(tmp_path / "p.msgpack"), 3, port, opt,
                         extra={"seed": 0})
    step, p, opt, extra = jck.restore_train_state(str(tmp_path / "p.msgpack"))
    assert step == 3 and extra == {"seed": 0}
    _assert_tree_equal(_from_jax(p), params)
    jck.save_train_state(str(tmp_path / "r.msgpack"), 4, params, None)
    step, p, opt, extra = tck.restore_train_state(str(tmp_path / "r.msgpack"),
                                                  device="cpu")
    assert step == 4 and opt is None and extra is None
    _assert_tree_equal(tree_to_numpy(p), params)


def test_corrupt_and_legacy_files(tmp_path):
    path = str(tmp_path / "c.msgpack")
    tck.save(path, {"w": torch.arange(64, dtype=torch.float32)})
    blob = open(path, "rb").read()
    for bad, why in ((blob[:len(blob) // 2], "not a readable"),
                     (blob[:-5] + bytes([blob[-5] ^ 0x10]) + blob[-4:],
                      "checksum mismatch")):
        with open(path, "wb") as f:
            f.write(bad)
        for pkg, kw in ((tck, dict(device="cpu")), (jck, {})):
            with pytest.raises(pkg.CheckpointCorruptError, match=why):
                pkg.restore(path, **kw)
    # a legacy bare tree (no envelope) loads in both
    legacy = {"w": {"__nd__": {"dtype": "float32", "shape": [2],
                               "data": np.float32([1, 2]).tobytes()}},
              "step": 5}
    with open(path, "wb") as f:
        f.write(msgpack.packb(legacy, use_bin_type=True))
    got = tck.restore(path, device="cpu")
    assert got["step"] == 5 and torch.equal(got["w"], torch.tensor([1., 2.]))
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    # an envelope whose payload passes its crc but does not parse
    payload = b"\xc1"
    with open(path, "wb") as f:
        f.write(msgpack.packb({"format": "ckpt-crc32-v1",
                               "crc32": zlib.crc32(payload),
                               "payload": payload}, use_bin_type=True))
    with pytest.raises(tck.CheckpointCorruptError, match="payload failed"):
        tck.restore(path, device="cpu")


def test_paged_helpers_name_order_and_refuse_as_the_reference(tmp_path):
    got, want = tmp_path / "port", tmp_path / "ref"
    for chunk in (3, 12, 1):
        a = tck.save_paged_state(str(got), chunk, {"x": torch.ones(2)})
        b = jck.save_paged_state(str(want), chunk, {"x": jnp.ones(2)})
        assert os.path.basename(a) == os.path.basename(b)
        assert open(a, "rb").read() == open(b, "rb").read()
    (got / "superstep_junk.msgpack").write_bytes(b"")
    (want / "superstep_junk.msgpack").write_bytes(b"")
    names = lambda chain: [os.path.basename(p) for p in chain]
    assert names(tck.paged_checkpoints(str(got))) == names(
        jck.paged_checkpoints(str(want))) == [
        "superstep_000012.msgpack", "superstep_000003.msgpack",
        "superstep_000001.msgpack"]
    assert os.path.basename(tck.latest_paged_checkpoint(str(got))) == \
        "superstep_000012.msgpack"
    assert tck.latest_paged_checkpoint(str(tmp_path / "none")) is None
    t = tck.restore_paged_state(tck.latest_paged_checkpoint(str(got)),
                                device="cpu")
    assert t["chunk"] == 12 and t["format"] == "paged-v1"
    plain = str(tmp_path / "plain.msgpack")
    tck.save(plain, {"format": "other"})
    with pytest.raises(ValueError, match="not a paged-v1 checkpoint"):
        tck.restore_paged_state(plain, device="cpu")
    with pytest.raises(ValueError, match="not a paged-v1 checkpoint"):
        jck.restore_paged_state(plain)


def test_restore_refuses_a_missing_card(tmp_path):
    path = str(tmp_path / "x.msgpack")
    tck.save(path, {"w": torch.ones(1)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tck.restore(path)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        tck.save(path, {"w": object()})
