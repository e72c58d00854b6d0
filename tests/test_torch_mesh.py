"""The port's mesh layer: the production meshes on a ``"fake"`` process
group (``repro_torch.launch.mesh``), the logical spec trees
(``transformer.param_specs`` / ``cache_specs``) against the JAX package's
``init_params(...)[1]`` and ``cache_specs`` for all 10 archs, and the
activation-constraint helpers (``models.layers``), which change nothing
until a launcher sets the batch axes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import transformer as ref_tf
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    """``{path: spec entries}`` of a nested dict of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree)}


def _ref_specs(arch):
    box = {}

    def only(key):
        params, specs = ref_tf.init_params(REF_ARCHS[arch], key)
        box["specs"] = specs
        return params

    jax.eval_shape(only, jax.random.key(0))
    return box["specs"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    want = _flat(_ref_specs(arch))
    got = _flat(tf.param_specs(ARCHS[arch]))
    assert got == want
    # and the port's params have exactly these paths
    meta = tf.init_params(ARCHS[arch], None, device="meta")
    assert set(_flat(tf._map(lambda t: L.P(), meta))) == set(got)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data"), ()])
def test_cache_specs_equal_the_reference(arch, batch_axes):
    ref = ref_tf.cache_specs(REF_ARCHS[arch], batch_axes)
    got = tf.cache_specs(ARCHS[arch], batch_axes)
    assert got.kind == ref.kind == tf.cache_kind(ARCHS[arch])
    assert [tuple(s) for s in got.data] == [tuple(s) for s in ref.data]
    assert tuple(got.length) == tuple(ref.length) == ()
    cache = tf.init_cache(ARCHS[arch], 2, 32, device="meta")
    assert len(cache.data) == len(got.data)


def test_partition_spec_is_a_tuple_of_entries():
    spec = L.P(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert repr(spec) == "P(('pod', 'data'), None, 'model')"
    import pickle

    assert pickle.loads(pickle.dumps(spec)) == spec
    assert isinstance(pickle.loads(pickle.dumps(spec)), L.PartitionSpec)


def test_constraints_are_no_ops_without_batch_axes():
    x = torch.randn(4, 3)
    assert L.get_batch_axes() is None
    assert L.constrain_batch_leading(x) is x
    assert L.constrain_spec(x, "data", None) is x
    L.set_batch_axes(("data",))
    try:  # a plain tensor is not sharded: left as it is
        assert L.constrain_batch_leading(x) is x
        assert L.constrain_spec(x, None, "model") is x
    finally:
        L.set_batch_axes(None)


MESHES = r"""
import sys
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import layers as L
from torch._subclasses.fake_tensor import FakeTensorMode

dryrun.fake_process_group(256)
m = M.make_production_mesh(device_type="cpu")
assert m.mesh_dim_names == ("data", "model") and m.shape == (16, 16), m
dryrun.fake_process_group(512)
m = M.make_production_mesh(multi_pod=True, device_type="cpu")
assert m.mesh_dim_names == ("pod", "data", "model") and m.shape == (2, 16, 16)
dryrun.fake_process_group(4)
for shape in ((4, 1), (2, 2), (1, 4)):
    m = M.make_mesh(shape, ("data", "model"), device_type="cpu")
    assert m.shape == shape
m = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
with FakeTensorMode():
    x = distribute_tensor(torch.empty(8, 6), m, [Replicate(), Replicate()])
    L.set_batch_axes(("data",))
    y = L.constrain_batch_leading(x)
    assert list(y.placements) == [Shard(0), Replicate()], y.placements
    assert tuple(y.to_local().shape) == (4, 6)
    z = L.constrain_spec(y, None, "model")
    assert list(z.placements) == [Replicate(), Shard(1)], z.placements
    assert L.constrain_spec(z, None, "model") is z  # already placed
print("MESH OK")
"""


def test_production_meshes_and_constraints_on_a_fake_group():
    """In a subprocess: the fake group is process-wide state."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    p = subprocess.run([sys.executable, "-c", MESHES], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "MESH OK" in p.stdout, p.stderr[-3000:]
