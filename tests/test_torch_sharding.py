"""The port's sharding rules (``repro_torch.sharding.rules``) and the dry
run's per-device bytes (``repro_torch.launch.specs``) on the CPU, held
against the JAX reference's ``repro.sharding.rules`` and
``repro.launch.specs`` on its abstract meshes.

Every arch at full size: the port's parameters on the meta device, the
reference's leaves from ``jax.eval_shape``; nothing is allocated.  A port
tensor is paired with the reference leaf it comes from by its name
without the layer index (``layers.3.attn.wq`` ↔ ``layers/attn/wq``, as
``models/convert.py`` pairs them); its spec must equal the leaf's with the
leading layer dims dropped (a hybrid's two) and, for an MoE expert tensor,
the expert entry moved to the front.  Per-device bytes must equal the sums
from the reference's specs over its abstract shapes exactly.
"""
import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models import model as jax_model
from repro.sharding import rules as jax_rules
from repro.utils.jaxcompat import abstract_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, cell_runnable, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.sharding import rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def jax_mesh(name):
    return abstract_mesh(*MESHES[name])


def port_mesh(name):
    return dict(zip(MESHES[name][1], MESHES[name][0]))


def _full(spec, ndim):
    """A reference PartitionSpec as a tuple of ``ndim`` entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def jax_leaves(tree):
    """``{path: leaf}`` of a reference tree, paths as ``layers/attn/wq``."""
    return {jax_rules._path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_spec_leaves(tree, specs_tree):
    flat = jax_leaves(tree)
    spec_flat = jax.tree.leaves(specs_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return {path: (leaf, _full(s, len(leaf.shape)))
            for (path, leaf), s in zip(flat.items(), spec_flat, strict=True)}


def jax_shard_bytes(leaf, spec, mesh):
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
            n *= mesh.shape[a]
    return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n


def _lead(cfg, path):
    """Leading layer dims of the reference's leaf at ``path``."""
    if path.startswith("enc_layers/"):
        return 1
    if path.startswith("layers/"):
        return 2 if cfg.hybrid_attn_every else 1
    return 0


_ABSTRACT: dict = {}


def jax_abstract(arch):
    if arch not in _ABSTRACT:
        cfg = jax_get_config(arch)
        _ABSTRACT[arch] = jax.eval_shape(lambda: jax_model.init_params(cfg, jax.random.PRNGKey(0)))
    return _ABSTRACT[arch]


def test_rule_path_drops_the_layer_index():
    assert rules.rule_path("layers.3.attn.wq") == "layers/attn/wq"
    assert rules.rule_path("enc_layers.12.mlp.wi") == "enc_layers/mlp/wi"
    assert rules.rule_path("shared_attn.attn.wo") == "shared_attn/attn/wo"
    assert rules.rule_path("layers.0.mlp.shared.wg") == "layers/mlp/shared/wg"
    assert rules.rule_path("embed") == "embed"


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model"), (32, 40), ("data", None)),  # 40 % 16 ≠ 0
    (("data", "model", None), (64, 32, 8), ("data", "model", None)),
    (("model",), (4, 32), (None, "model")),  # padded to rank
    (("data", "model", None), (16, 16), (None, None)),  # longer than the shape
    ((("pod", "data"), None), (64, 3), (("pod", "data"), None)),
    ((("pod", "data"), None), (16, 3), (None, None)),  # 16 % 32 ≠ 0
])
def test_finalize_spec_pads_and_drops(spec, shape, want):
    mesh = port_mesh("2x16x16")
    assert rules.finalize_spec(spec, shape, mesh) == want
    if want != (None,) * len(shape):  # where the spec fits the rank, as the reference
        assert rules.finalize_spec(spec, shape, mesh) == _full(
            jax_rules.finalize_spec(spec, shape, jax_mesh("2x16x16")), len(shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh_name):
    cfg = get_config(arch)
    ref = jax_spec_leaves(jax_abstract(arch),
                          jax_rules.param_specs(jax_abstract(arch), jax_mesh(mesh_name)))
    model = specs.abstract_params(cfg)
    got = rules.param_specs(model.named_parameters(), port_mesh(mesh_name), cfg.moe is not None)
    seen = set()
    for name, p in model.named_parameters():
        path = rules.rule_path(name)
        leaf, want = ref[path]
        lead = _lead(cfg, path)
        want = want[lead:]
        shape = tuple(leaf.shape[lead:])
        if cfg.moe and path.endswith(("mlp/wi", "mlp/wg", "mlp/wo")):
            want = (want[1], want[0], want[2])  # the expert entry to the front
            shape = (shape[1], shape[0], shape[2])
        assert tuple(p.shape) == shape, name
        assert got[name] == want, f"{arch} {name}: {got[name]} != {want}"
        seen.add(path)
    assert seen == set(ref)


def test_moe_expert_sharding_fallback():
    """mixtral: 8 experts on a 16-way model axis, so the expert dim is not
    sharded and the FFN dim is; deepseek-v2-236b: 160 experts divide 16,
    expert parallelism."""
    mesh = make_production_mesh()
    for arch, ep in (("mixtral-8x22b", False), ("deepseek-v2-236b", True)):
        cfg = get_config(arch)
        got = rules.param_specs(specs.abstract_params(cfg).named_parameters(), mesh, True)
        wi, wo = got["layers.0.mlp.wi"], got["layers.0.mlp.wo"]  # (E, d, fe), (E, fe, d)
        if ep:
            assert wi == ("model", "data", None) and wo == ("model", None, "data")
        else:
            assert wi == (None, "data", "model") and wo == (None, "model", "data")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_on_production_mesh(arch):
    cfg = get_config(arch)
    mesh = make_production_mesh()
    state = specs.abstract_train_state(cfg)
    sspec = specs.state_specs(cfg, state, mesh)
    for t, spec in specs.spec_pairs(state, sspec):
        assert len(spec) == t.dim()
        for dim, entry in zip(t.shape, spec):
            if entry is not None:
                assert dim % rules._axis_size(mesh, entry) == 0


def _ref_bytes(tree, specs_tree, mesh):
    return sum(jax_shard_bytes(leaf, spec, mesh)
               for leaf, spec in jax_spec_leaves(tree, specs_tree).values())


def _port_bytes(args, spec_tree, mesh):
    return sum(rules.shard_bytes(t.numel() * t.element_size(), s, mesh)
               for t, s in specs.spec_pairs(args, spec_tree))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_train_state_bytes_equal_the_references(arch, mesh_name):
    cfg = get_config(arch)
    jmesh, mesh = jax_mesh(mesh_name), port_mesh(mesh_name)
    params = jax_abstract(arch)
    want_params = _ref_bytes(params, jax_rules.param_specs(params, jmesh), jmesh)
    jstate = jax_specs.abstract_train_state(jax_get_config(arch))
    want_state = _ref_bytes(jstate, jax_specs.state_specs(jax_get_config(arch), jstate, jmesh),
                            jmesh)
    model = specs.abstract_params(cfg)
    got_params = _port_bytes(model, rules.param_specs(model.named_parameters(), mesh,
                                                      cfg.moe is not None), mesh)
    state = specs.abstract_train_state(cfg)
    got_state = _port_bytes(state, specs.state_specs(cfg, state, mesh), mesh)
    assert got_params == want_params
    assert got_state == want_state


DECODE_CELLS = [(arch, shape) for arch in ARCH_IDS for shape in ("decode_32k", "long_500k")
                if cell_runnable(get_config(arch), SHAPES[shape])[0]]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cell_bytes_equal_the_references(arch, shape, mesh_name):
    """Parameters and cache per device of a decode cell, the cache's specs
    batch-sharded (decode_32k) or sequence-sharded (long_500k, B = 1)."""
    cfg = get_config(arch)
    jcfg, jshape = jax_get_config(arch), JAX_SHAPES[shape]
    jmesh, mesh = jax_mesh(mesh_name), port_mesh(mesh_name)
    n_data = int(np.prod([jmesh.shape[a] for a in jax_rules.batch_axes(jmesh)]))
    shardable = jshape.global_batch >= n_data
    cache = jax.eval_shape(lambda: jax_model.init_cache(jcfg, jshape.global_batch, jshape.seq_len))
    if jcfg.encoder:
        params = jax_abstract(arch)
        enc = jax.ShapeDtypeStruct((jshape.global_batch, jcfg.encoder.n_frames, jcfg.d_model),
                                   jax.numpy.dtype(jcfg.dtype))
        cache = dict(cache, cross=jax.eval_shape(
            lambda p, e: jax_model.init_cross_cache(jcfg, p, e), params, enc))
    want_cache = _ref_bytes(cache, jax_specs.cache_specs(cache, jmesh, shardable), jmesh)
    params = jax_abstract(arch)
    want_params = _ref_bytes(params, jax_rules.param_specs(params, jmesh), jmesh)

    _, (model, tokens, pcache), (pspec, tspec, cspec), meta = specs.build_cell(
        cfg, SHAPES[shape], mesh)
    assert meta["batch_shardable"] is shardable
    assert _port_bytes(pcache, cspec, mesh) == want_cache
    assert _port_bytes(model, pspec, mesh) == want_params
    assert specs.argument_bytes((model, tokens, pcache), (pspec, tspec, cspec), mesh) == (
        want_params + want_cache + _port_bytes(tokens, tspec, mesh))


@pytest.mark.parametrize("leaf,shape,shardable,want", [
    ("layers/0/k", (128, 8, 32768, 128), True, ("data", None, None, None)),  # 8 heads
    ("layers/0/k", (1, 32, 4096, 128), False, (None, "model", "data", None)),
    ("layers/0/ckv", (1, 524288, 512), False, (None, "data", None)),
    ("ssm/3/conv", (128, 3, 10240), True, ("data", None, "model")),
    ("ssm/3/h", (1, 160, 64, 64), False, (None, "model", None, None)),  # Mamba-2
    ("layers/0/h", (128, 8192, 16), True, ("data", "model", None)),  # Mamba-1
    ("cross/5/0", (128, 16, 1500, 64), True, ("data", "model", None, None)),
    ("layers/0/pos", (128,), True, (None,)),
])
def test_cache_spec_cases(leaf, shape, shardable, want):
    assert specs._cache_spec_for(leaf, shape, make_production_mesh(), shardable) == want


def test_host_mesh_is_one_card():
    mesh = make_host_mesh()
    assert mesh == {"data": 1, "model": 1}
    cfg = get_config("qwen2-vl-2b")
    model = specs.abstract_params(cfg)
    pspec = rules.param_specs(model.named_parameters(), mesh)
    assert _port_bytes(model, pspec, mesh) == sum(
        p.numel() * p.element_size() for p in model.parameters())
