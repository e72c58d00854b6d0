"""The port's sharding glue (``repro_torch.launch.sharding``) against the
JAX package's ``repro.launch.sharding`` and ``repro.launch.dryrun``.

The main parity check: for all 80 dry-run cells (10 archs x 4 shapes x
the 16x16 and 2x16x16 meshes) at full width, every leaf of the step's
inputs -- params, AdamW moments, batch, decode cache -- has the same
per-device shape on both sides.  The reference's side runs in a
subprocess with 512 host devices: ``eval_shape`` trees, its own
``sanitize_specs`` and ``resolve_spec``, and ``NamedSharding.shard_shape``
(nothing is compiled).  The port's side runs in another subprocess: the
dry-run's ``build_cell`` makes fake DTensors on a ``"fake"`` process group
of 256 or 512 ranks, whose local shapes are read (nothing is traced).  So
both give the same per-device argument bytes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import sharding
from repro_torch.models.layers import P, spec_placements

ROOT = Path(__file__).resolve().parents[1]

# Per-device shapes of every input leaf of every cell, by name
# ("params/layers/attn/wq", "opt/m/...", "batch/tokens", "cache/0", ...).
REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import SHAPES
from repro.configs.registry import ARCHS, cell_runnable, input_specs
from repro.launch.dryrun import GRAD_ACCUM, effective_batch_axes, sanitize_specs
from repro.launch.sharding import resolve_spec
from repro.models.transformer import Cache, cache_specs, init_params

def flat(tree, specs, prefix, out):
    if isinstance(tree, dict):
        for k in tree:
            flat(tree[k], specs[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = (tree, specs)

res = {}
for multi in (False, True):
    shape_ = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    n = int(np.prod(shape_))
    mesh = jax.make_mesh(shape_, axes, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(axes))
    for arch, cfg in ARCHS.items():
        box = {}
        def only(key):
            p, s = init_params(cfg, key)
            box["s"] = s
            return p
        psds = jax.eval_shape(only, jax.random.key(0))
        pspecs = sanitize_specs(psds, box["s"], mesh)
        for sname, shape in SHAPES.items():
            if not cell_runnable(cfg, shape)[0]:
                continue
            ba = effective_batch_axes(mesh, shape.global_batch, cfg.layout)
            leaves = {}
            flat(psds, pspecs, "params", leaves)
            def shard(sds, spec):
                return list(NamedSharding(mesh, resolve_spec(spec, mesh)).shard_shape(sds.shape))
            cell = {}
            for name, (sds, spec) in leaves.items():
                cell[name] = [shard(sds, spec), str(sds.dtype)]
            batch = input_specs(cfg, shape)
            if shape.kind == "train":
                adam = str(jnp.dtype(cfg.adam_dtype))
                for name, (sds, spec) in leaves.items():
                    for m in ("m", "v"):
                        cell["opt/" + m + name[len("params"):]] = [shard(sds, spec), adam]
                cell["opt/step"] = [[], "int32"]
                cell["step"] = [[], "int32"]
            if shape.kind in ("train", "prefill"):
                for k, v in batch.items():
                    cell["batch/" + k] = [shard(v, P(ba, *(None,) * (len(v.shape) - 1))), str(v.dtype)]
            else:
                cache = batch["cache"]
                cs = cache_specs(cfg, ba)
                fixed = sanitize_specs(Cache(cache.kind, cache.data, jax.ShapeDtypeStruct((), jnp.int32)),
                                       Cache(cs.kind, cs.data, P()), mesh)
                for i, (sds, spec) in enumerate(zip(cache.data, fixed.data)):
                    cell[f"cache/{i}"] = [shard(sds, spec), str(sds.dtype)]
                cell["cache/length"] = [[], "int32"]
                tok = batch["tokens"]
                cell["tokens"] = [shard(tok, P(ba, None)), str(tok.dtype)]
            res[f"{arch}/{sname}/{int(multi)}"] = cell
json.dump(res, open(sys.argv[1], "w"))
"""

PORT = r"""
import json, sys
import torch
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, cell_runnable
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Cache
from torch._subclasses.fake_tensor import FakeTensorMode

def flat(tree, prefix, out):
    if isinstance(tree, Cache):
        for i, t in enumerate(tree.data):
            out[f"{prefix}/{i}"] = t
        out[f"{prefix}/length"] = tree.length
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), f"{prefix}/{f}", out)
    else:
        out[prefix] = tree

res, args_bytes = {}, {}
for multi in (False, True):
    for arch in ARCHS:
        for sname, shape in SHAPES.items():
            if not cell_runnable(ARCHS[arch], shape)[0]:
                continue
            mesh, cfg, fn, args = dryrun.build_cell(
                arch, sname, multi, device="cpu", fake_mode=FakeTensorMode())
            names = {"train": ("params", "opt", "batch", "step"),
                     "prefill": ("params", "batch"),
                     "decode": ("params", "cache", "tokens")}[shape.kind]
            leaves = {}
            for name, tree in zip(names, args):
                flat(tree, name, leaves)
            cell = {}
            for name, t in leaves.items():
                loc = t.to_local() if hasattr(t, "to_local") else t
                cell[name] = [list(loc.shape), str(loc.dtype).removeprefix("torch.")]
            res[f"{arch}/{sname}/{int(multi)}"] = cell
            args_bytes[f"{arch}/{sname}/{int(multi)}"] = dryrun.local_bytes(args)
json.dump({"cells": res, "bytes": args_bytes}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def shard_shapes(tmp_path_factory):
    """Both sides' per-device shapes of all 80 cells (two subprocesses,
    run at once)."""
    out = tmp_path_factory.mktemp("shards")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    runs = {}
    for side, script in (("reference", REFERENCE), ("port", PORT)):
        runs[side] = subprocess.Popen(
            [sys.executable, "-c", script, str(out / f"{side}.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for side, proc in runs.items():
        text, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{side}:\n{text[-3000:]}"
    ref = json.loads((out / "reference.json").read_text())
    port = json.loads((out / "port.json").read_text())
    return ref, port["cells"], port["bytes"]


def _nbytes(entry) -> int:
    shape, dtype = entry
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=getattr(torch, dtype)).element_size()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_device_shapes_equal_the_reference(arch, shard_shapes):
    """Every leaf of every cell of ``arch`` (4 shapes x 2 meshes where
    runnable), and so the per-device argument bytes."""
    ref, port, port_bytes = shard_shapes
    cells = [c for c in ref if c.startswith(arch + "/")]
    assert sorted(cells) == sorted(c for c in port if c.startswith(arch + "/"))
    assert len(cells) == (8 if ARCHS[arch].ssm else 6)
    for cell in cells:
        assert ref[cell] == port[cell], cell
        ref_bytes = sum(_nbytes(e) for e in ref[cell].values())
        assert port_bytes[cell] == ref_bytes, cell


def test_eighty_cells_forty_runnable_each_mesh(shard_shapes):
    ref, port, _ = shard_shapes
    assert len(ref) == len(port) == 64  # 80 cells, 16 of them long_500k skips


# -- the glue itself --------------------------------------------------------------


class _Mesh:
    """The parts of a DeviceMesh that the spec functions read."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names, self.ndim = shape, names, len(names)

    def size(self, i):
        return self.shape[i]


def test_batch_axes_and_resolve_spec_follow_the_reference():
    from jax.sharding import PartitionSpec as JP

    from repro.launch import sharding as ref

    class _JMesh:
        def __init__(self, names):
            self.axis_names = names

    for names in (("data", "model"), ("pod", "data", "model")):
        ours, theirs = _Mesh((2,) * len(names), names), _JMesh(names)
        assert sharding.batch_axes(ours) == ref.batch_axes(theirs)
        assert tuple(sharding.batch_spec(ours)) == tuple(ref.batch_spec(theirs))
        for spec in ((("pod", "data"), None), ("model", "data"), (None, "pod"),
                     ((), "model")):
            want = tuple(ref.resolve_spec(JP(*spec), theirs))
            assert tuple(sharding.resolve_spec(P(*spec), ours)) == want


def test_spec_placements_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh((2, 4, 4), ("pod", "data", "model"))
    assert spec_placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert spec_placements(P(None, "data"), mesh) == [Replicate(), Shard(1),
                                                      Replicate()]
    # axes the mesh lacks are dropped
    assert spec_placements(P("pod", "model"), _Mesh((4, 4), ("data", "model"))) \
        == [Replicate(), Shard(1)]


def test_placements_for_refuses_an_uneven_shard():
    mesh = _Mesh((2, 4), ("data", "model"))
    sharding.placements_for((8, 12), P("data", "model"), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.placements_for((8, 10), P("data", "model"), mesh)


def test_map_specs_walks_caches_and_named_tuples():
    from repro_torch.models.transformer import Cache
    from repro_torch.train.optimizer import AdamWState

    specs = AdamWState(step=P(), m={"w": P("data")}, v={"w": P(None)})
    vals = AdamWState(step=1, m={"w": 2}, v={"w": 3})
    got = sharding.map_specs(lambda s, x: (tuple(s), x), specs, vals)
    assert got == AdamWState(step=((), 1), m={"w": (("data",), 2)},
                             v={"w": ((None,), 3)})
    cache = sharding.map_specs(lambda s, x: x * 10,
                               Cache("gqa", (P(), P()), P()),
                               Cache("gqa", (1, 2), 3))
    assert cache == Cache("gqa", (10, 20), 30)


def test_param_and_batch_shardings():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh((2, 2), ("data", "model"))
    got = sharding.param_sharding({"a": P("data", "model"), "b": P("pod")}, mesh)
    assert got == {"a": [Shard(0), Shard(1)], "b": [Replicate(), Replicate()]}
    got = sharding.batch_shardings({"tokens": 0, "mask": 1}, mesh)
    assert got == {"tokens": [Shard(0), Replicate()],
                   "mask": [Shard(0), Replicate()]}
