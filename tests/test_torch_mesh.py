"""The port's meshes and parameter spec tables (`fa2_triton_tpu_torch/
parallel/mesh.py`) against the JAX package's (`fa2_triton_tpu/parallel/
mesh.py`) on the CPU: `param_pspecs`, `serving_param_pspecs` and
`fsdp_param_pspecs` equal JAX's on the same tiny LLaMA (with Qwen2-style
qkv biases) and on its int8-quantized tree, with and without TP, JAX's on
its 8-device virtual mesh; `make_mesh` / `make_multihost_mesh` lay the
ranks of a spawned 8-rank gloo world out as JAX lays its devices; and
`shard_params`' pieces rebuild the full weights."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fa2_triton_tpu.models import llama as jl  # noqa: E402
from fa2_triton_tpu.parallel import mesh as jm  # noqa: E402
from fa2_triton_tpu_torch.models import LlamaConfig  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.models.llama import quantize_model_params  # noqa: E402
from fa2_triton_tpu_torch.parallel import mesh as tm  # noqa: E402
from fa2_triton_tpu_torch.parallel import spawn_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_ranks as tpr  # noqa: E402

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
          max_seq_len=256, qkv_bias=True)


@pytest.fixture(scope="module")
def trees():
    """{"dense" / "int8": (JAX params, the port's model)} on the same weights."""
    jp = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig(dtype=jnp.float32, **KW))
    model = llama_from_jax_params(jax.tree.map(np.asarray, jp),
                                  LlamaConfig(dtype=torch.float32, **KW), device="cpu")
    return {"dense": (jp, model), "int8": (jl.quantize_model_params(jp),
                                           quantize_model_params(model))}


def _jax_named(specs) -> dict:
    """JAX's spec tree as {dotted name: tuple of axis names}."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name = ".".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)
        out[name] = tuple(spec)
    return out


@pytest.mark.parametrize("tree", ["dense", "int8"])
@pytest.mark.parametrize("table", ["param_pspecs", "serving_param_pspecs"])
def test_tp_spec_tables_equal_jax(trees, tree, table):
    jp, model = trees[tree]
    want = _jax_named(getattr(jm, table)(jp))
    got = getattr(tm, table)(model)
    assert got == want
    if tree == "int8":
        assert got["layers.0.wq.qscale"] == (None, "model")
        assert got["layers.1.w_down.qvalues"] == ("model", None)


@pytest.mark.parametrize("tree", ["dense", "int8"])
@pytest.mark.parametrize("shape,min_size", [(None, 2 ** 14), ({"data": 8}, 2 ** 10),
                                            ({"data": 4, "model": 2}, 2 ** 10),
                                            ({"data": 2, "model": 4}, 2 ** 8)])
def test_fsdp_specs_equal_jax(trees, tree, shape, min_size):
    """FSDP specs alone and composed with TP, at JAX's mesh shapes."""
    jp, model = trees[tree]
    jmesh = (jm.make_mesh(**shape, devices=jax.devices()[:int(np.prod(list(shape.values())))])
             if shape else None)
    want = _jax_named(jm.fsdp_param_pspecs(jp, jmesh, min_size=min_size))
    assert tm.fsdp_param_pspecs(model, shape, min_size=min_size) == want


@pytest.mark.parametrize("tree", ["dense", "int8"])
@pytest.mark.parametrize("table,axis,n", [("serving", "model", 2), ("fsdp", "data", 4)])
def test_shard_params_pieces_rebuild_the_model(trees, tree, table, axis, n):
    """Each rank's `shard_params` piece along `axis`, concatenated along the
    dim its spec cuts, is the full leaf, and replicated leaves are shared
    (the serving TP table, and the FSDP table over data 4)."""
    _, model = trees[tree]
    specs = (tm.serving_param_pspecs(model) if table == "serving"
             else tm.fsdp_param_pspecs(model, {axis: n}, min_size=2 ** 10))
    pieces = [tm.shard_params(model, {axis: n}, specs, coords={axis: i}) for i in range(n)]
    for name, leaf in tm.named_leaves(model).items():
        parts = [tm.named_leaves(p)[name] for p in pieces]
        dims = [d for d, a in enumerate(specs[name]) if a == axis]
        if not dims:
            assert all(p is leaf for p in parts), name
            continue
        assert parts[0].shape[dims[0]] == leaf.shape[dims[0]] // n
        assert torch.equal(torch.cat(parts, dim=dims[0]), leaf), name
    want = (2, 1) if axis == "model" else (4, 2)
    assert all((p.cfg.n_heads, p.cfg.n_kv_heads) == want for p in pieces)


def test_shard_params_keeps_whole_gqa_groups(trees):
    _, model = trees["dense"]
    local = tm.shard_params(model, {"model": 2}, tm.serving_param_pspecs(model), {"model": 1})
    assert (local.cfg.n_heads, local.cfg.n_kv_heads, local.cfg.hd) == (2, 1, 16)
    assert local.layers[0].wq.shape == (64, 32) and local.layers[0].wk.shape == (64, 16)
    assert local.lm_head is model.lm_head
    with pytest.raises(ValueError, match="multiples of the model axis"):
        tm.shard_params(model, {"model": 4}, tm.serving_param_pspecs(model), {"model": 0})


@pytest.fixture(scope="module")
def meshes():
    shapes = [{"data": 2, "model": 2, "seq": 2}, {"pipe": 2, "data": 2, "model": 2},
              {"multihost": (2, 2, 8)}, {"multihost": (2, 1, 4)}]
    return shapes, spawn_ranks(tpr.mesh_rank, 8, (shapes,), timeout_s=300)


@pytest.mark.parametrize("i", range(4))
def test_mesh_layout_equals_jax(meshes, i):
    """Axis names and order, and the rank at each place, equal JAX's device
    ids at that place on its 8 virtual devices; each rank's place and
    groups agree with the layout."""
    shapes, ranks = meshes
    shape = shapes[i]
    if "multihost" in shape:
        model, seq, local = shape["multihost"]
        assert local in (4, 8)
        jmesh = jm.make_multihost_mesh(model=model, seq=seq)
    else:
        jmesh = jm.make_mesh(**shape)
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, res in enumerate(ranks):
        got = res[i]
        assert tuple(got["names"]) == tuple(jmesh.axis_names)
        assert np.array_equal(got["layout"], want)
        place = tuple(got["coords"][n] for n in got["names"])
        assert got["layout"][place] == rank
        for a, n in enumerate(got["names"]):
            line = np.moveaxis(got["layout"], a, -1)[tuple(p for b, p in enumerate(place) if b != a)]
            assert got["groups"][n] == [int(r) for r in line]


def test_multihost_mesh_refuses_groups_across_hosts():
    with pytest.raises(RuntimeError, match="process group"):
        tm.make_mesh(model=2)
