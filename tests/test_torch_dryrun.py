"""The dry run's modules without JAX (``configs/shapes.py``,
``serving/kvcache.py::init_compressed_cache_spec``,
``distributed/sharding.py``, ``launch/mesh.py``, ``launch/dryrun.py``)
against the JAX package's on all 40 cells at full size.

Equal to ``repro``'s: every input spec and compressed-cache spec (shapes
and dtypes, the same tree), applicability, skip reasons, ``model_flops``,
and the partition specs of parameters, inputs and caches on both
production meshes (``repro``'s ``PartitionSpec``s converted to tuples),
with the duck-typed mesh ``tests/test_sharding.py`` uses.  Per-device bytes
are held to a sum over ``repro``'s specs and shapes written out here; the
collective bytes to a case worked by hand on a 2 x 2 mesh.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices when it is
imported, so it is only ever imported in a subprocess (``model_flops``)."""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALIASES, get_config, reduced_config
from repro_torch.configs import shapes as TS
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TM
from repro_torch.serving.kvcache import init_compressed_cache_spec

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ALIASES for s in TS.SHAPES]


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (spec rules need no
    devices), as tests/test_sharding.py's."""
    def __init__(self, shape: dict):
        self._shape = shape

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import types

    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget
    from repro.configs import shapes as JS
    from repro.distributed import sharding as JSH
    from repro.models import encdec as JE
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, P=P, get_config=jget, S=JS,
                                 SH=JSH, E=JE, T=JT, KV=JKV)


def _flat(J, tree):
    """[(path, shape, dtype name)] of a tree of tensors or SDSs."""
    return [(J.jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).split(".")[-1])
            for p, x in J.jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _jax_inputs(arch: str, shape: str):
    from repro.configs import get_config as jget
    from repro.configs.shapes import input_specs
    return input_specs(jget(arch), shape)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    import jax

    from repro.configs import get_config as jget
    from repro.models import encdec as JE
    from repro.models import transformer as JT
    cfg = jget(arch)
    init = JE.init_encdec_params if cfg.family == "audio" else JT.init_params
    return jax.eval_shape(lambda: init(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_compressed_cache_specs_equal_repro(J, arch, shape):
    tcfg, jcfg = get_config(arch), J.get_config(arch)
    want = _flat(J, _jax_inputs(arch, shape))
    got = TS.input_specs(tcfg, shape)
    assert all(t.device.type == "meta"
               for t in J.jax.tree_util.tree_leaves(got))
    assert _flat(J, got) == want
    sp = TS.SHAPES[shape]
    got = init_compressed_cache_spec(tcfg, sp.global_batch, sp.seq_len)
    assert all(t.device.type == "meta"
               for t in J.jax.tree_util.tree_leaves(got))
    assert _flat(J, got) == _flat(J, J.KV.init_compressed_cache_spec(
        jcfg, sp.global_batch, sp.seq_len))


@pytest.fixture(scope="module")
def repro_model_flops():
    """``repro.launch.dryrun.model_flops`` of every cell, from a
    subprocess (the module sets XLA_FLAGS at import)."""
    pytest.importorskip("jax")
    code = ("import json\n"
            "from repro.configs import get_config\n"
            "from repro.configs.shapes import all_cells\n"
            "from repro.launch.dryrun import model_flops\n"
            "print(json.dumps({a + '|' + s: model_flops(get_config(a), s)"
            " for a, s in all_cells()}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicability_and_model_flops_equal_repro(J, repro_model_flops,
                                                   arch, shape):
    tcfg, jcfg = get_config(arch), J.get_config(arch)
    assert TS.cell_is_applicable(tcfg, shape) == \
        J.S.cell_is_applicable(jcfg, shape)
    assert TS.skip_reason(tcfg, shape) == J.S.skip_reason(jcfg, shape)
    assert TS.step_kind(shape) == J.S.step_kind(shape)
    assert D.model_flops(tcfg, shape) == repro_model_flops[f"{arch}|{shape}"]
    assert list(TS.all_cells()) == list(J.S.all_cells()) == CELLS


def _jax_spec_leaves(J, tree, specs):
    """(path, shape, spec as a tuple) of a JAX tree and its spec tree."""
    leaves = J.jax.tree_util.tree_flatten_with_path(tree)[0]
    sl = J.jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, J.P))
    assert len(sl) == len(leaves)
    return [(J.jax.tree_util.keystr(p), tuple(x.shape), tuple(s))
            for (p, x), s in zip(leaves, sl)]


def _port_spec_leaves(J, tree, specs):
    return [(J.jax.tree_util.keystr(p), tuple(x.shape), s)
            for (p, x), (_, s) in zip(
                J.jax.tree_util.tree_flatten_with_path(tree)[0],
                TSH.spec_leaves(tree, specs))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(ALIASES))
def test_param_specs_and_bytes_equal_repro(J, arch, mesh):
    """param_pspecs at full size; shard_bytes against the per-device sum
    over repro's specs written out here (each dim over its axes' devices,
    rounded up)."""
    m = FakeMesh(MESHES[mesh])
    tcfg, jcfg = get_config(arch), J.get_config(arch)
    jparams = _jax_params(arch)
    want = _jax_spec_leaves(J, jparams, J.SH.param_pspecs(jcfg, jparams, m))
    tparams = D.abstract_params(tcfg)
    tspecs = TSH.param_pspecs(tcfg, tparams, m)
    assert _port_spec_leaves(J, tparams, tspecs) == want

    def dev(ax):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        return math.prod(MESHES[mesh][a] for a in axes)
    want_bytes = 0
    for (_, x), spec in zip(
            J.jax.tree_util.tree_flatten_with_path(jparams)[0],
            [s for _, _, s in want]):
        spec = spec + (None,) * (len(x.shape) - len(spec))
        want_bytes += x.dtype.itemsize * math.prod(
            -(-d // dev(ax)) for d, ax in zip(x.shape, spec))
    assert TSH.shard_bytes(tparams, tspecs, m) == want_bytes


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_equal_repro(J, arch, shape):
    tcfg, jcfg = get_config(arch), J.get_config(arch)
    jin = _jax_inputs(arch, shape)
    tin = TS.input_specs(tcfg, shape)
    for mesh in MESHES.values():
        m = FakeMesh(mesh)
        jspecs = J.SH.batch_pspecs(jcfg, jin, m)
        tspecs = TSH.batch_pspecs(tcfg, tin, m)
        assert sorted(jspecs) == sorted(tspecs)
        for k in jin:
            assert _port_spec_leaves(J, tin[k], tspecs[k]) == \
                _jax_spec_leaves(J, jin[k], jspecs[k]), k
        if "cache" in jin:
            B = TS.SHAPES[shape].global_batch
            assert _port_spec_leaves(
                J, tin["cache"],
                TSH.cache_pspecs(tcfg, tin["cache"], m, B)) == \
                _jax_spec_leaves(J, jin["cache"], J.SH.cache_pspecs(
                    jcfg, jin["cache"], m, B))


def test_meshes_describe_repro_meshes():
    one = TM.make_production_mesh()
    two = TM.make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.devices) == (
        ("data", "model"), {"data": 16, "model": 16}, ())
    assert (two.axis_names, two.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert TSH.dp_axes(two) == ("pod", "data")
    cpu = [torch.device("cpu")] * 4
    host = TM.make_host_mesh(2, 2, devices=cpu)
    assert host.shape == {"data": 2, "model": 2} and len(host.devices) == 4
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        TM.make_host_mesh(2, 4, devices=cpu)


def test_shard_shape_rounds_up_and_pads_the_spec():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert TSH.shard_shape((4, 64, 33), (None, ("pod", "data"), "model"),
                           m) == (4, 2, 3)
    assert TSH.shard_shape((5, 7), ("model",), m) == (1, 7)
    x = torch.empty((32, 48), dtype=torch.bfloat16, device="meta")
    assert TSH.shard_bytes({"a": [x, x]}, {"a": [("data", None), ()]},
                           m) == 2 * 48 * 2 + 32 * 48 * 2


# The hand-worked case: reduced qwen3-4b (2 layers, d 64, Hq 4, G 2, hd 16,
# d_ff 128, vocab 256, remat off) trained at B 4 x S 8 on a 2 x 2 mesh.
# bf16 weights, their blocks under (., data, model) / (., model, data) and
# gathered over "data":
#   embed (256, 64)      block (128, 32) 8,192 B, gathered (128, 64) 16,384
#   wq, wo (2, 64, 64)   block 4,096 each, gathered 8,192 each
#   wk, wv (2, 64, 32)   block 2,048 each, gathered 4,096 each
#   w_in, w_gate, w_out  block 8,192 each, gathered 16,384 each
# all-gather (one forward, no remat): 16,384 + 2 * 8,192 + 2 * 4,096
#   + 3 * 16,384 = 90,112; reduce-scatter: 8,192 + 2 * 4,096 + 2 * 2,048
#   + 3 * 8,192 = 45,056.
# f32 leaves without an FSDP axis, all-reduced whole (dp 2): final_norm 256,
#   ln1 and ln2 512 each, q_norm and k_norm 128 each = 1,536.
# row-parallel activations: (B/dp 2, S 8, d 64) bf16 = 2,048 B, for 2
#   attention and 2 MLP outputs, over 2 passes (forward, backward): 16,384.
# G 2 splits whole over model 2: no score all-reduce.  With
#   seq_parallel_attn, each of 2 layers and 2 passes adds the f32 stats
#   2 * (2, Hq 4, S 8) * 4 = 512 and one activation (2, 8, 4 * 16) bf16 =
#   2,048: 10,240 more.
HAND = {"all-gather": 90_112, "reduce-scatter": 45_056,
        "all-reduce": 1_536 + 16_384}


@pytest.mark.parametrize("seqattn", [False, True])
def test_collective_bytes_equal_the_hand_worked_case(seqattn):
    cfg = reduced_config(get_config("qwen3-4b")).with_(
        seq_parallel_attn=seqattn)
    m = FakeMesh({"data": 2, "model": 2})
    params = D.abstract_params(cfg)
    specs = TSH.param_pspecs(cfg, params, m)
    got = D.collective_bytes(cfg, "train", 4, 8, params, specs, m)
    want = dict(HAND)
    want["all-reduce"] += 10_240 if seqattn else 0
    want["total"] = sum(want.values())
    assert got == want
    # remat: the gather again for the recompute, a third pass
    got = D.collective_bytes(cfg.with_(remat=True), "train", 4, 8, params,
                             specs, m)
    assert got["all-gather"] == 2 * HAND["all-gather"]
    assert got["all-reduce"] == 1_536 + 3 * (16_384 + (
        10_240 if seqattn else 0)) // 2


def test_counted_flops_cover_model_flops_on_a_reduced_train_cell():
    cfg = reduced_config(get_config("qwen3-4b"))
    rec = D.run_cell("qwen3-4b", "train_4k", verbose=False, cfg=cfg,
                     mesh=FakeMesh({"data": 2, "model": 2}))
    port = rec["port"]
    assert port["counted_flops"] >= rec["model_flops"] > 0
    assert port["useful_flops_ratio"] == rec["model_flops"] / \
        port["counted_flops"]
    assert port["bottleneck"] in ("compute", "memory", "collective")
    assert rec["bytes_per_device"]["argument"] == sum(
        rec["bytes_per_device"][k]
        for k in ("params", "opt_state", "inputs", "cache"))
    assert "temp" not in json.dumps(rec) and "hlo" not in json.dumps(rec)


@pytest.mark.parametrize("variant", list(D.VARIANTS))
def test_every_variant_builds_and_counts(variant):
    """Each of repro's variants on the port's config (reduced gemma3-12b,
    windowed and global layers, at train_4k's shape on meta); the
    sequence-parallel ones trade the score all-reduce (G 2 does not split
    over model 16) for the stats and one activation."""
    cfg = reduced_config(get_config("gemma3-12b"))
    mesh = TM.make_production_mesh()
    rec = D.run_cell("gemma3-12b", "train_4k", variant=variant,
                     verbose=False, cfg=cfg.with_(**D.VARIANTS[variant]),
                     mesh=mesh)
    base = D.run_cell("gemma3-12b", "train_4k", verbose=False, cfg=cfg,
                      mesh=mesh)
    assert rec["port"]["counted_flops"] > 0
    seq = "seqattn" in variant
    ar, base_ar = (r["port"]["collective_bytes"]["all-reduce"]
                   for r in (rec, base))
    if seq:
        assert ar < base_ar
    elif variant not in ("noremat", "banded"):
        assert ar == base_ar


def test_the_cli_runs_without_jax(tmp_path):
    out = tmp_path / "cells.json"
    code = ("import runpy, sys\n"
            f"sys.argv = ['dryrun', '--arch', 'xlstm-125m', '--shape', "
            f"'long_500k', '--out', {str(out)!r}]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('jax loaded:', 'jax' in sys.modules)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "jax loaded: False" in res.stdout
    assert "[dryrun] 1 cells, 0 failures" in res.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert rec["port"]["device"] == "NVIDIA H100 80GB HBM3"
    assert rec["port"]["counted_flops"] > 0
