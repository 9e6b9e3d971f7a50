"""The port's planner against the reference, on the CPU: `launch/mesh.py`,
`launch/sharding.py`, `roofline/analysis.py` and `launch/dryrun.py`.

The sharding rules are pure metadata, so they are held against the
reference's at the reference's own mesh shapes, with no device: the
reference's on `jax.sharding.AbstractMesh` over `jax.eval_shape`d trees,
the port's on `launch.mesh.Mesh` over ``meta`` tensors.  Every spec must
be equal, leaf for leaf:

- `param_specs` of every architecture's published config, client-stacked
  (the train case's layout) and serving, on the (1, 1), (16, 16) and
  (2, 16, 16) meshes;
- `batch_specs` and `cache_specs` for the four input shapes on
  gemma2-27b, deepseek-v3-671b, zamba2-2.7b and whisper-tiny;
- the ``serve_tp`` branch, which no config sets: nemotron-4-340b (its
  clients span a pod) with ``apply_overrides({"serve_tp": True})``.

Then `data_axes`, `client_axes`, `n_clients`, `model_flops`,
`apply_overrides` and `INPUT_SHAPES` against the reference's;
`collective_bytes` against `parse_collective_bytes` on the same
collectives, and the c10d ops a one-rank gloo group's mix issues
recorded by the planner's dispatch mode; the planner's extrapolation
exact on a config of 5 groups
(a direct count of the loop form equals the count extrapolated from 2
and 3 groups); the flash op's flop formula against a hand count of the
kept pairs (causal, windowed, prefix); and one planned case written as
an artifact with every `RooflineTerms` field.  Counts are exact
(integers); no tolerance.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import active_param_count as jactive_param_count
from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.launch import dryrun as jdryrun
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro.roofline import analysis as janalysis
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch import mesh as pmesh
from repro_torch.models import transformer as T
from repro_torch.roofline import RooflineTerms, collective_bytes, model_flops

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPE_ARCHS = ("gemma2-27b", "deepseek-v3-671b", "zamba2-2.7b",
               "whisper-tiny")
KEY = jax.random.PRNGKey(0)


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), pmesh.Mesh(axes, sizes,
                                                 torch.device("meta"))


def _jflat(specs):
    """{dotted path: tuple} of a reference spec tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        parts = []
        for k in path:
            parts.append(str(getattr(k, "key", getattr(
                k, "name", getattr(k, "idx", k)))))
        out[".".join(parts)] = tuple(leaf)
    return out


def _pflat(specs, path=()):
    """{dotted path: tuple} of a port spec tree."""
    if isinstance(specs, sharding.Spec):
        return {".".join(path): tuple(specs)}
    out = {}
    if isinstance(specs, dict):
        items = [(str(k), v) for k, v in specs.items()]
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        items = list(zip(specs._fields, specs))
    else:
        items = [(str(i), v) for i, v in enumerate(specs)]
    for k, v in items:
        out.update(_pflat(v, path + (k,)))
    return out


def _same_specs(got, want):
    g, w = _pflat(got), _jflat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k] == w[k], (k, g[k], w[k])


@pytest.fixture(scope="module")
def trees():
    """Each architecture's unstacked params (the case builders' layout):
    the reference's `eval_shape`d, the port's on ``meta``."""
    out = {}
    for arch in configs.ARCH_IDS:
        jcfg = jget_config(arch)
        jtree = jax.eval_shape(lambda k: jsteps.init_model_params(k, jcfg),
                               KEY)
        ptree = steps.init_model_params(torch.Generator(),
                                        configs.get_config(arch),
                                        device="meta")
        out[arch] = (jtree, ptree)
    return out


def _jstack(tree, m):
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((m,) + s.shape, s.dtype), tree)


def _pstack(tree, m):
    return steps._stack(tree, m)


def test_archs_and_input_shapes_match_reference():
    assert sorted(configs.ARCH_IDS) == sorted(J_ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in
            steps.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jsteps.INPUT_SHAPES.items()}
    for arch in configs.ARCH_IDS:
        pcfg, jcfg = configs.get_config(arch), jget_config(arch)
        assert configs.param_count(pcfg) == jparam_count(jcfg)
        assert configs.active_param_count(pcfg) == \
            jactive_param_count(jcfg)
        for name, s in steps.INPUT_SHAPES.items():
            assert model_flops(pcfg, s.kind, s.seq_len, s.global_batch) == \
                janalysis.model_flops(jcfg, s.kind, s.seq_len,
                                      s.global_batch)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axes_match_reference(mesh_name):
    jm, pm = _meshes(mesh_name)
    assert pm.shape == dict(jm.shape)
    assert pmesh.data_axes(pm) == jmesh.data_axes(jm)
    for arch in configs.ARCH_IDS:
        pcfg, jcfg = configs.get_config(arch), jget_config(arch)
        for axis in ("data", "pod", "all"):
            pc = dataclasses.replace(pcfg, fl_client_axis=axis)
            jc = dataclasses.replace(jcfg, fl_client_axis=axis)
            assert pmesh.client_axes(pm, pc) == jmesh.client_axes(jm, jc)
            assert pmesh.n_clients(pm, pc) == jmesh.n_clients(jm, jc)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_reference(trees, mesh_name):
    jm, pm = _meshes(mesh_name)
    for arch in configs.ARCH_IDS:
        pcfg, jcfg = configs.get_config(arch), jget_config(arch)
        jtree, ptree = trees[arch]
        # serving: the single model
        _same_specs(sharding.param_specs(ptree, pcfg, pm, serve=True),
                    jsharding.param_specs(jtree, jcfg, jm, serve=True))
        # training: client-stacked, m of the mesh's clients
        m = jmesh.n_clients(jm, jcfg)
        _same_specs(
            sharding.param_specs(_pstack(ptree, m), pcfg, pm,
                                 client_stacked=True),
            jsharding.param_specs(_jstack(jtree, m), jcfg, jm,
                                  client_stacked=True))


def _jcaches(jcfg, b, shape):
    def mk():
        c = jT.make_caches(jcfg, b, shape.seq_len, jcfg.cdtype,
                           long_context=shape.long_context)
        return jscan.stack_caches(c, jcfg) if jsteps._use_scan(jcfg) else c
    return jax.eval_shape(mk)


@pytest.mark.parametrize("arch", SHAPE_ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    pcfg, jcfg = configs.get_config(arch), jget_config(arch)
    for mesh_name in ("16x16", "2x16x16"):
        jm, pm = _meshes(mesh_name)
        m = jmesh.n_clients(jm, jcfg)
        for name, shape in steps.INPUT_SHAPES.items():
            jshape = jsteps.INPUT_SHAPES[name]
            if shape.kind == "train":
                _same_specs(
                    sharding.batch_specs(steps.train_batch_struct(
                        pcfg, shape, m), pcfg, pm, client_dim=True),
                    jsharding.batch_specs(jsteps.train_batch_struct(
                        jcfg, jshape, m), jcfg, jm, client_dim=True))
                continue
            _same_specs(
                sharding.batch_specs(steps.serve_batch_struct(pcfg, shape),
                                     pcfg, pm),
                jsharding.batch_specs(jsteps.serve_batch_struct(
                    jcfg, jshape), jcfg, jm))
            b = shape.global_batch
            pc = steps._make_caches(pcfg, b, shape, steps._use_scan(pcfg),
                                    "meta")
            _same_specs(sharding.cache_specs(pc, pcfg, pm, batch=b),
                        jsharding.cache_specs(_jcaches(jcfg, b, jshape),
                                              jcfg, jm, batch=b))


def test_serve_tp_branch_matches_reference(trees):
    pcfg = dryrun.apply_overrides(configs.get_config("nemotron-4-340b"),
                                  {"serve_tp": True})
    jcfg = jdryrun.apply_overrides(jget_config("nemotron-4-340b"),
                                   {"serve_tp": True})
    assert pcfg.serve_tp and dataclasses.asdict(pcfg) == \
        dataclasses.asdict(jcfg)
    assert dataclasses.asdict(dryrun.apply_overrides(
        configs.get_config("deepseek-v3-671b"),
        {"attn.mla_absorb": True})) == dataclasses.asdict(
        jdryrun.apply_overrides(jget_config("deepseek-v3-671b"),
                                {"attn.mla_absorb": True}))
    jtree, ptree = trees["nemotron-4-340b"]
    shape = steps.INPUT_SHAPES["decode_32k"]
    for mesh_name in ("16x16", "2x16x16"):
        jm, pm = _meshes(mesh_name)
        _same_specs(sharding.param_specs(ptree, pcfg, pm, serve=True),
                    jsharding.param_specs(jtree, jcfg, jm, serve=True))
        pc = steps._make_caches(pcfg, 128, shape, True, "meta")
        _same_specs(sharding.cache_specs(pc, pcfg, pm, batch=128,
                                         seq_shard=True),
                    jsharding.cache_specs(_jcaches(jcfg, 128, shape), jcfg,
                                          jm, batch=128, seq_shard=True))


def test_collective_bytes_match_hlo_parse():
    hlo = "\n".join([
        "  %ag = bf16[2,1024,512]{2,1,0} all-gather(bf16[1,1024,512] %p)",
        "  %ars = f32[4,8]{1,0} all-reduce-start(f32[4,8] %x)",
        "  %ard = f32[4,8]{1,0} all-reduce-done(f32[4,8] %ars)",
        "  %rs = f32[16]{0} reduce-scatter(f32[256] %y)",
        "  %cp = s32[3,5]{1,0} collective-permute(s32[3,5] %z)",
    ])
    records = [("all-gather", 2 * 1024 * 512 * 2),
               ("all-reduce-start", 4 * 8 * 4), ("all-reduce-done", 128),
               ("reduce-scatter", 16 * 4), ("collective-permute", 60)]
    assert collective_bytes(records) == \
        janalysis.parse_collective_bytes(hlo)


def test_traffic_records_the_collectives_a_group_issues():
    """With a process group running (one gloo rank here), the gspmd mix
    all-gathers the flat rows: `_Traffic` records it as (all-gather, its
    output bytes); a process alone (`ONE_PROCESS`) issues nothing."""
    import torch.distributed as dist
    from repro_torch.core.distributed import ONE_PROCESS, mix_schedule
    flat = {"a": torch.ones((1, 6)), "b": torch.ones((1, 2, 5))}
    w = torch.ones((1, 1))
    started = False
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        started = True
    try:
        traffic = dryrun._Traffic()
        with traffic:
            out = mix_schedule(None, flat, w)
        assert torch.equal(out["b"], flat["b"])
        assert collective_bytes(traffic.collectives) == {
            "all-gather": (6 + 10) * 4, "all-reduce": 0,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    finally:
        if started:
            dist.destroy_process_group()
    traffic = dryrun._Traffic()
    with traffic:
        mix_schedule(ONE_PROCESS, flat, w)
    assert traffic.collectives == []


def test_extrapolation_exact_past_three_groups():
    cfg = dataclasses.replace(configs.get_smoke_config("stablelm-3b"),
                              n_layers=5)
    mesh = pmesh.make_host_mesh("cpu")
    for shape in ("train_4k", "decode_32k"):
        kw = {"remat": True} if shape == "train_4k" else {}
        extra = dryrun.extrapolated_costs(cfg, mesh, shape, kw)
        direct = dryrun.count_case(steps.build_case(cfg, mesh, shape,
                                                    loop=True, **kw))
        assert extra["flops"] == direct["flops"] > 0
        assert extra["bytes"] == direct["bytes"] > 0


@pytest.mark.parametrize("sq,sk,causal,window,prefix",
                         [(16, 16, True, None, 0), (12, 40, True, 9, 0),
                          (20, 20, True, 6, 8), (3, 30, True, None, 0),
                          (10, 24, False, None, 0)])
def test_flash_flop_formula_counts_kept_pairs(sq, sk, causal, window,
                                              prefix):
    b, h, kh, dk, dv = 2, 4, 2, 16, 8
    q = torch.empty((b, h, sq, dk), device="meta")
    k = torch.empty((b, kh, sk, dk), device="meta")
    v = torch.empty((b, kh, sk, dv), device="meta")
    with FlopCounterMode(display=False) as fc:
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  prefix_len=prefix)
    assert tuple(out.shape) == (b, h, sq, dv)
    qp = np.arange(sk - sq, sk)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= (kp <= qp) | (kp < prefix)
    if window:
        keep &= kp > qp - window
    assert fc.get_total_flops() == 2 * (dk + dv) * b * h * int(keep.sum())


def test_planned_case_writes_every_roofline_field(tmp_path):
    cfg = configs.get_smoke_config("stablelm-3b")
    mesh = pmesh.make_card_mesh("meta")
    res = dryrun.run_case("stablelm-3b", "decode_32k", mesh=mesh, cfg=cfg,
                          out_dir=str(tmp_path), verbose=False)
    path = tmp_path / dryrun.mesh_name(mesh) / "stablelm-3b__decode_32k.json"
    art = json.loads(path.read_text())
    for f in dataclasses.fields(RooflineTerms):
        assert f.name in art
    assert art == json.loads(json.dumps(res))
    assert art["flops_per_device"] > 0 and art["bytes_per_device"] > 0
    assert art["fits"] and art["bottleneck"] in ("compute", "memory")
    assert art["collective_bytes_per_device"] == 0.0
    with pytest.raises(RuntimeError, match="cannot run on meta"):
        dryrun.count_case(steps.TrainCase(
            fn=lambda t: T.lockstep_position(t), args=(
                torch.empty(2, device="meta"),), in_shardings=(),
            out_shardings=None, donate_argnums=(), meta={}))
