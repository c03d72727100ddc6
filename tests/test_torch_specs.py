"""The port's placement rules (``repro_torch.sharding.specs``,
``launch/mesh.py``'s production meshes, ``launch/steps.py``'s spec
helpers) against the reference's on the same shapes.

The reference's spec functions read a mesh's axis names and sizes only, so
they take ``jax.sharding.AbstractMesh`` es of the production shapes, with no
256 devices; the port's take its own ``Mesh`` of meta devices. Specs are
compared entry for entry (exact: they are rules, not arithmetic), after
writing a one-name tuple entry as its name on both sides. About 20 s on one
CPU core, most of it ``jax.eval_shape`` of the ten full-size inits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    INPUT_SHAPES,
    get_config,
)
from repro_torch.convert import flatten_tree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    dp_axes,
    make_host_mesh,
    make_production_mesh,
    num_clients_for,
)
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

# (port mesh, reference abstract mesh) of the same sizes and names
MESHES = {
    "16x16": (make_production_mesh(),
              AbstractMesh((16, 16), ("data", "model"))),
    "2x16x16": (make_production_mesh(multi_pod=True),
                AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
    "host": (make_host_mesh(), AbstractMesh((1, 1), ("data", "model"))),
}


def _norm(spec):
    """A spec as a plain tuple, a one-name tuple entry as its name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _jspec(x):
    return _norm(getattr(x, "spec", x))


# tests/test_substrates.py's fixed cases (its numpy draw, seed 0)
_SPEC_DIMS = [1, 2, 3, 16, 32, 64, 256, 1024, 4096]
_rng = np.random.default_rng(0)
_SPEC_CASES = (
    [[1], [4096], [1, 1, 1, 1], [4096, 4096, 4096, 4096]]
    + [[int(_rng.choice(_SPEC_DIMS))
        for _ in range(int(_rng.integers(1, 5)))] for _ in range(56)])
# tests/test_lm_sweep.py's uneven cases, on an 8-way model axis
_UNEVEN = [(577, 1535), (49153, 577), (577, 1536), (7,), (3, 5)]


def test_production_meshes_and_their_axes():
    for name, (mesh, jm) in MESHES.items():
        assert mesh.axis_names == tuple(jm.axis_names), name
        assert mesh.shape == dict(jm.shape), name
        assert _norm(dp_axes(mesh)) == _norm(jmesh.dp_axes(jm)), name
        assert num_clients_for(mesh) == jmesh.num_clients_for(jm), name
    assert make_production_mesh().size == 256
    assert make_production_mesh(multi_pod=True).size == 512
    assert {d.type for d in make_production_mesh().devices} == {"meta"}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("client_axis", [False, True])
def test_spec_for_shape_on_the_reference_cases(mesh_name, client_axis):
    mesh, jm = MESHES[mesh_name]
    for dims in _SPEC_CASES:
        got = specs.spec_for_shape(tuple(dims), mesh, client_axis=client_axis)
        want = jspecs.spec_for_shape(tuple(dims), jm,
                                     client_axis=client_axis)
        assert _norm(got) == _jspec(want), dims


def test_spec_for_shape_uneven_fallback():
    mesh = Mesh(("model",), (8,), ("meta",) * 8)
    jm = AbstractMesh((8,), ("model",))
    for shape in _UNEVEN:
        assert _norm(specs.spec_for_shape(shape, mesh)) == _jspec(
            jspecs.spec_for_shape(shape, jm)), shape
    assert specs.spec_for_shape((577, 1535), mesh) == (None, "model")


def _ref_param_shapes(arch):
    cfg = jget_config(arch)
    tree = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))
    return {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_infer_pytree_specs_on_every_leaf_at_full_size(arch):
    """Every leaf of the full-size init, by the reference's names, on every
    mesh, with and without a leading client axis (m = 2); also decode's
    ``_tp2d_spec`` on the two production meshes."""
    assert list(ARCH_IDS) == list(JARCH_IDS)
    shapes = _ref_param_shapes(arch)
    port = {k: tuple(v.shape) for k, v in
            steps.empty_params(get_config(arch)).items()}
    assert port == shapes
    structs = {k: jax.ShapeDtypeStruct(s, np.float32)
               for k, s in shapes.items()}
    nested = jax.eval_shape(
        lambda: jinit_params(jax.random.PRNGKey(0), jget_config(arch)))
    for name, (mesh, jm) in MESHES.items():
        for client in (False, True):
            lead = (2,) if client else ()
            jtree = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(lead + tuple(x.shape),
                                               x.dtype), nested)
            want = flatten_tree(jspecs.infer_pytree_specs(
                jtree, jm, client_axis=client))
            got = specs.infer_pytree_specs(
                {k: lead + s for k, s in shapes.items()},
                mesh, client_axis=client)
            assert set(got) == set(want)
            for k in got:
                assert _norm(got[k]) == _jspec(want[k]), (name, client, k)
        if name != "host":
            for k, s in shapes.items():
                want = jsteps._tp2d_spec(structs[k], jm)
                assert _norm(steps._tp2d_spec(s, mesh)) == _jspec(want), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_leaf_specs(arch):
    """``_cache_leaf_spec`` on every leaf of ``make_cache`` at decode_32k's
    batch and length, by name, on every mesh."""
    shape = INPUT_SHAPES["decode_32k"]
    b, t = shape.global_batch, shape.seq_len
    assert (JSHAPES["decode_32k"].global_batch, JSHAPES["decode_32k"].seq_len
            ) == (b, t)
    jcache = jax.eval_shape(lambda: jmake_cache(jget_config(arch), b, t))
    cache = flatten_tree(make_cache(get_config(arch), b, t, device="meta"))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in flatten_tree(jcache).items()}
    for name, (mesh, jm) in MESHES.items():
        want = flatten_tree(jax.tree_util.tree_map_with_path(
            lambda path, x: jsteps._cache_leaf_spec(path, x, jm, b), jcache))
        _, c_specs, tok = steps.serve_shardings(
            steps.empty_params(get_config(arch)),
            make_cache(get_config(arch), b, t, device="meta"), mesh, b)
        got = {f"{i}.{k}": sp for i, c in enumerate(c_specs)
               for k, sp in c.items()}
        for k in cache:
            assert _norm(got[k]) == _jspec(want[k]), (name, k)
            assert _norm(steps._cache_leaf_spec(
                k.rsplit(".", 1)[-1], cache[k].shape, mesh, b)) == _norm(
                    got[k])
        dp = jmesh.dp_axes(jm)
        size = int(np.prod([jm.shape[a] for a in dp]))
        assert _norm(tok) == _norm((dp if b % size == 0 else None, None))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec(mesh_name):
    mesh, jm = MESHES[mesh_name]
    for shape in [(1, 1, 256, 4096), (2, 1, 128, 4096), (2, 3, 8, 16),
                  (4, 1, 48), (3, 2), (2, 1, 256, 8, 1024)]:
        assert _norm(steps._batch_spec(shape, mesh)) == _jspec(
            jsteps._batch_spec(shape, jm)), shape


def test_placements_of_a_spec():
    """Specs become DTensor placements, one per mesh axis: a dim over two
    axes is sharded on both, major first; an out-of-order pair raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(multi_pod=True)
    P = specs.P
    assert specs.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert specs.placements(P(None, ("data", "model")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    assert specs.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        specs.placements(P(("model", "data")), mesh)
    # rank 0's shard: the ceiling, as GSPMD pads
    assert specs.shard_shape((577, 49152), P("model", "data"),
                             make_production_mesh()) == (37, 3072)
    assert specs.shard_shape((576, 577), P(None, ("data", "model")),
                             make_production_mesh()) == (576, 3)
