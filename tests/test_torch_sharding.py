"""The port's sharding rules and scoring mesh against the JAX package's.

Each rule of ``repro_torch.parallel.sharding`` is held entry by entry to
its ``repro.parallel.sharding`` counterpart on a JAX ``AbstractMesh`` of
the same shape (the port's rules read only a mesh's ``axis_names`` and
``shape``, so both take the same mesh): the cases of
``tests/test_sharded_scoring.py`` and ``tests/test_sharding.py``, and
hypothesis properties over dims, groups and frame counts. A port spec is
a tuple with the ``PartitionSpec``'s entries. ``make_scoring_mesh``
returns None at one slot or fewer and takes a device more than once.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_scoring_mesh  # noqa: E402
from repro_torch.parallel import ops as pops  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402


def _amesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


DATA4 = _amesh((4,), ("data",))
POD = _amesh((16, 16), ("data", "model"))
MULTI = _amesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"data4": DATA4, "pod": POD, "multipod": MULTI}


def same(spec, jspec) -> bool:
    return spec == tuple(jspec)


@pytest.mark.parametrize("mesh", MESHES)
def test_default_rules_match(mesh):
    assert shd.default_rules(MESHES[mesh]) == jshd.default_rules(MESHES[mesh])


# (shape, mesh) of tests/test_sharded_scoring.py's frames and superbatch
# cases, dividing and not
SCORING = [((64, 25, 25, 3), "frames"), ((63, 25, 25, 3), "frames"),
           ((8, 256, 50, 50, 3), "super"), ((3, 256, 50, 50, 3), "super"),
           ((4, 1024, 100, 100, 3), "super"), ((5, 300, 50, 50, 3), "super")]


@pytest.mark.parametrize("shape,kind", SCORING)
def test_scoring_specs_and_fallbacks_match(shape, kind):
    fn, jfn = ((shd.frames_spec, jshd.frames_spec) if kind == "frames"
               else (shd.superbatch_spec, jshd.superbatch_spec))
    fb, jfb = [], []
    assert same(fn(shape, DATA4, fb), jfn(shape, DATA4, jfb))
    assert fb == jfb
    assert (fb == []) == (shape[0] % 4 == 0)


def test_explain_fallbacks_matches():
    fb = [("group", 3, ("data",)), ("group", 3, ("data",)),
          ("group", 5, ("data",)), ("frames", 255, ("data",)),
          ("vocab", 30, ("model",))]
    assert shd.explain_fallbacks(fb) == jshd.explain_fallbacks(fb)
    assert {e["axis"]: e for e in shd.explain_fallbacks(fb)}["group"] == \
        {"axis": "group", "mesh_axes": ["data"], "count": 3, "dims": [3, 5]}
    assert shd.explain_fallbacks([]) == []


# (shape, axes, mesh, rules) of tests/test_sharding.py and
# tests/test_sharded_scoring.py's spec_for_leaf cases
LEAVES = [((4096, 256), ("embed", "ffn"), "pod", None),
          ((30, 256), ("vocab", "embed"), "pod", None),
          ((8, 64), ("layer", None), "pod", None),
          ((64, 25), (None, None), "data4", {"frames": ("data",)}),
          ((64, 25), ("mystery", None), "data4", {"frames": ("data",)}),
          ((63, 25), ("frames", None), "data4", {"frames": ("data",)}),
          ((64, 25), ("frames", None), "data4", {"frames": ("data",)}),
          ((512, 4096), ("batch", None), "multipod", None),
          ((40, 1536, 512), ("expert", "embed", None), "pod", None)]


@pytest.mark.parametrize("i", range(len(LEAVES)))
def test_spec_for_leaf_matches(i):
    shape, axes, mesh, rules = LEAVES[i]
    m = MESHES[mesh]
    rules = rules if rules is not None else jshd.default_rules(m)
    fb, jfb = [], []
    assert same(shd.spec_for_leaf(shape, axes, m, rules, fb),
                jshd.spec_for_leaf(shape, axes, m, rules, jfb))
    assert fb == jfb


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_match(mesh):
    m = MESHES[mesh]
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
             "labels": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 8), jnp.int32),
             "pos": jax.ShapeDtypeStruct((1,), jnp.int32),
             "scalar": jax.ShapeDtypeStruct((), jnp.int32)}
    got = shd.data_batch_specs(m, batch)
    want = jshd.data_batch_specs(m, batch)
    assert set(got) == set(want)
    for k in batch:
        assert same(got[k], want[k].spec), k
    assert same(shd.batch_sharding(m), jshd.batch_sharding(m).spec)
    assert same(shd.replicated(m), jshd.replicated(m).spec)
    # a (torch or numpy) batch takes the same rule
    t = shd.data_batch_specs(m, {"tokens": torch.zeros(256, 8),
                                 "pos": np.zeros(1)})
    assert t["tokens"][0] == want["tokens"].spec[0] and t["pos"] == ()


@given(st.integers(min_value=1, max_value=4096),
       st.sampled_from(["embed", "vocab", "heads", "ffn", "expert", "batch"]),
       st.sampled_from(["pod", "multipod"]))
def test_spec_for_leaf_property(dim, ax, mesh):
    m = MESHES[mesh]
    rules = jshd.default_rules(m)
    fb, jfb = [], []
    assert same(shd.spec_for_leaf((dim, 8), (ax, None), m, rules, fb),
                jshd.spec_for_leaf((dim, 8), (ax, None), m, rules, jfb))
    assert fb == jfb


@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=2048),
       st.integers(min_value=2, max_value=8))
def test_scoring_specs_property(group, frames, slots):
    """Group-split iff the group divides the slots, whatever the frame
    count; frames split iff they divide; as the JAX package's rules."""
    m = _amesh((slots,), ("data",))
    sb = (group, frames, 25, 25, 3)
    assert same(shd.superbatch_spec(sb, m), jshd.superbatch_spec(sb, m))
    assert (shd.superbatch_spec(sb, m)[0] == "data") == (group % slots == 0)
    assert same(shd.frames_spec(sb[1:], m), jshd.frames_spec(sb[1:], m))
    port = make_scoring_mesh(["cpu"] * slots)
    assert shd.superbatch_spec(sb, port) == shd.superbatch_spec(sb, m)


def test_scoring_mesh():
    assert make_scoring_mesh(["cpu"]) is None
    assert make_scoring_mesh([]) is None
    mesh = make_scoring_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_names == ("data",)
    assert mesh.shape == {"data": 4} and mesh.group is None
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert shd.default_rules(mesh) == jshd.default_rules(DATA4)
    if torch.cuda.device_count() <= 1:
        assert make_scoring_mesh() is None       # one card or none
    with pops.use_mesh(mesh, shd.default_rules(mesh)):
        assert pops.data_group_count() == 4 == pops.local_group_count()
        assert pops.data_ranks() == 1 == pops.data_slices()
    assert pops.data_group_count() == 1


def test_local_mesh_without_a_process_group():
    mesh = make_local_mesh("cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.group is None and mesh.processes == 1
    with pops.use_mesh(mesh, shd.default_rules(mesh)):
        assert pops.data_group_count() == 1
