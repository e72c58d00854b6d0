"""The port's checkpoints (``repro_torch.checkpoint.checkpointer``) and its
train launcher's restart, on the CPU.

A checkpoint of ``{"params": ..., "opt": AdamWState}`` written by either
package restores in the other, bit for bit (bfloat16 leaves as their raw
bits): the manifests name every leaf letter for letter alike.  A torn
``.tmp`` directory is never restored.  The launcher, killed after a
checkpoint and started again, resumes there and ends on the same state
as an uninterrupted run.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as ref_ckpt
from repro.configs.registry import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer

ROOT = Path(__file__).resolve().parents[1]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str, seed: int = 0):
    """The reference's train state with non-zero moments and step: two
    updates of random gradients (jitted)."""
    cfg = ref_smoke(REF_ARCHS[arch])

    def make(key):
        params, _ = ref_tf.init_params(cfg, key)
        opt = ref_opt.adamw_init(params, dtype=jnp.dtype(cfg.adam_dtype))
        for i in range(2):
            grads = jax.tree.map(
                lambda p, i=i: jax.random.normal(jax.random.key(i), p.shape,
                                                 p.dtype), params)
            params, opt, _ = ref_opt.adamw_update(grads, opt, params, lr=1e-2)
        return {"params": params, "opt": opt}

    return jax.jit(make)(jax.random.key(seed))


def _port_like(arch: str):
    cfg = smoke_config(ARCHS[arch])
    params = tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    return {"params": params,
            "opt": optimizer.adamw_init(params,
                                        dtype=getattr(torch, cfg.adam_dtype))}


def _manifest(path):
    return json.loads((Path(path) / "manifest.json").read_text())["leaves"]


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """granite (float32 throughout) and deepseek-v3 (bfloat16 params and
    moments, an int32 step)."""
    state = _ref_state(arch)
    ref_ckpt.save_checkpoint(str(tmp_path), 2, state)
    assert ckpt.latest_step(str(tmp_path)) == 2
    got = ckpt.restore_checkpoint(str(tmp_path), 2, _port_like(arch))
    names = [e["name"] for e in _manifest(tmp_path / "step_00000002")]
    ours = [n for n, _ in ckpt._flatten_with_paths(got)]
    assert ours == names
    want = {"__".join(str(p) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(state)[0]}
    for name, leaf in ckpt._flatten_with_paths(got):
        np.testing.assert_array_equal(_bits(leaf), _ref_bits(want[name]))
    assert int(got["opt"].step) == 2
    if arch == "deepseek-v3-671b":
        assert got["opt"].m["layers"]["attn"]["w_dq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    state = _ref_state(arch, seed=3)
    port_state = {"params": params_from_numpy(
        jax.tree.map(np.asarray, state["params"]), "cpu"),
        "opt": optimizer.AdamWState(
            step=torch.tensor(int(state["opt"].step), dtype=torch.int32),
            m=params_from_numpy(jax.tree.map(np.asarray, state["opt"].m), "cpu"),
            v=params_from_numpy(jax.tree.map(np.asarray, state["opt"].v), "cpu"))}
    path = ckpt.save_checkpoint(str(tmp_path), 7, port_state)
    assert not os.path.exists(path + ".tmp")
    assert ref_ckpt.latest_step(str(tmp_path)) == 7
    like = jax.eval_shape(lambda: state)
    got = ref_ckpt.restore_checkpoint(str(tmp_path), 7, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_ref_bits(a), _ref_bits(b))
    # the same names, in the same order, as the reference writes
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, state)
    assert [(e["name"], e["dtype"], e["shape"]) for e in _manifest(path)] == [
        (e["name"], e["dtype"], e["shape"])
        for e in _manifest(tmp_path / "ref" / "step_00000007")]


def test_roundtrip_in_place_and_torn_checkpoints(tmp_path):
    like = _port_like("granite-3-2b")
    saved = _port_like("granite-3-2b")
    saved["params"]["embed"]["table"].add_(1.0)
    saved["opt"] = saved["opt"]._replace(step=torch.tensor(5, dtype=torch.int32))
    ckpt.save_checkpoint(str(tmp_path), 5, saved)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crash mid-write
    os.makedirs(tmp_path / "step_00000008")  # no manifest
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ref_ckpt.latest_step(str(tmp_path)) == 5
    table = like["params"]["embed"]["table"]
    got = ckpt.restore_checkpoint(str(tmp_path), 5, like)
    assert got is like and got["params"]["embed"]["table"] is table
    for (_, a), (_, b) in zip(ckpt._flatten_with_paths(got),
                              ckpt._flatten_with_paths(saved)):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_restore_rejects_another_shape_or_dtype(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="saved float32"):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="saved float32"):
        ckpt.restore_checkpoint(str(tmp_path), 1,
                                {"w": torch.zeros(3, dtype=torch.bfloat16)})


def _run_train(ckpt_dir, steps, *extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "granite-3-2b", "--smoke", "--device", "cpu", "--steps", str(steps),
           "--batch", "2", "--seq", "64", "--ckpt-dir", str(ckpt_dir),
           "--ckpt-every", "3", "--log-every", "3", *extra]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def _load(path):
    return {e["name"]: np.load(Path(path) / e["file"]) for e in _manifest(path)}


def test_launcher_restarts_from_its_checkpoint(tmp_path):
    """Train to step 3, stop, launch again to step 6: the second run
    resumes from step 3 and its step-6 checkpoint equals an uninterrupted
    run's bit for bit (the data is a function of the step and the CPU's
    sums run in a fixed order)."""
    cut = tmp_path / "interrupted"
    _run_train(cut, 3)
    out = _run_train(cut, 6)
    assert "resumed from step 3" in out, out
    straight = tmp_path / "straight"
    assert "resumed" not in _run_train(straight, 6)
    a = _load(cut / "step_00000006")
    b = _load(straight / "step_00000006")
    assert a.keys() == b.keys() and "['opt']__.step" in a
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert int(a["['opt']__.step"]) == 6
    # the launcher's checkpoint restores in the reference too
    like = jax.eval_shape(lambda: _ref_state("granite-3-2b"))
    got = ref_ckpt.restore_checkpoint(str(cut), 6, like)
    assert int(got["opt"].step) == 6


def test_launcher_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["internvl2-26b", "dbrx-132b", "zamba2-1.2b"])
def test_launcher_trains_other_families_on_cpu(arch):
    """A frontend arch (zero frontend embeddings, as the reference feeds
    them), an MoE arch and a hybrid arch: two finite steps each."""
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                      "2", "--batch", "2", "--seq", "64", "--log-every", "1"])
    assert out["start"] == 0 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"] + out["gnorms"]))


def test_launcher_metrics_dir_and_profile_on_cpu(tmp_path):
    """``--metrics-dir`` writes a ``train.loss`` gauge a step with its step
    label; ``--profile-steps 1`` a trace under ``profile/``; obs is off
    again afterwards."""
    from repro_torch import obs
    from repro_torch.launch import train

    out = train.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch",
                      "2", "--seq", "64", "--log-every", "3", "--metrics-dir",
                      str(tmp_path), "--profile-steps", "1"])
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    loss = [r for r in recs if r["metric"] == "train.loss"]
    assert [r["step"] for r in loss] == [0, 1, 2]
    assert [r["value"] for r in loss] == pytest.approx(out["losses"])
    assert list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert not obs.enabled()


# -- specs and elastic re-sharding --------------------------------------------------

RESHARD = r"""
import datetime, json, sys
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves
from repro_torch.checkpoint import checkpointer as C
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import distribute
from repro_torch.models import transformer as T

rank, ckpt, init = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                        world_size=4, timeout=datetime.timedelta(seconds=120))
cfg = smoke_config(ARCHS["deepseek-v3-671b"])  # bf16 params, MLA, MoE
params = T.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
specs = dryrun.sanitize_specs(params, T.param_specs(cfg), mesh)
C.save_checkpoint(ckpt, 3, {"params": distribute(params, specs, mesh)},
                  specs={"params": specs})
mesh41 = make_mesh((4, 1), ("data", "model"), device_type="cpu")
back = C.restore_checkpoint(ckpt, 3, {"params": params}, mesh=mesh41)["params"]
whole = C.restore_checkpoint(
    ckpt, 3, {"params": T._map(torch.zeros_like, params)})["params"]
differ = 0
for a, b, c in zip(tree_leaves(params), tree_leaves(back), tree_leaves(whole)):
    assert b.device_mesh is mesh41
    full = b.full_tensor()
    differ += int((a.view(torch.int16) if a.dtype == torch.bfloat16 else a).ne(
        full.view(torch.int16) if full.dtype == torch.bfloat16 else full).sum())
    differ += int((a.float() != c.float()).sum())
dist.destroy_process_group()
print("DIFFER", differ)
"""


def test_resharded_restore_on_four_gloo_ranks(tmp_path):
    """Saved from a (2, 2) mesh with specs, restored with ``mesh=`` on
    (4, 1) and unsharded: bit for bit, on 4 gloo ranks."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RESHARD, str(r), str(tmp_path / "ck"),
         str(tmp_path / "init")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[-2000:] for o in outs]
    assert all("DIFFER 0" in o for o in outs), outs
    # every leaf's spec is in the manifest
    specs = [e.get("spec") for e in _manifest(tmp_path / "ck" / "step_00000003")]
    assert all(s is not None for s in specs)


def test_specs_go_into_the_manifest_as_the_reference_writes_them(tmp_path):
    from jax.sharding import NamedSharding

    cfg = smoke_config(ARCHS["granite-3-2b"])
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = tf.param_specs(cfg)
    path = ckpt.save_checkpoint(str(tmp_path), 5, {"params": params},
                                specs={"params": specs})
    ref_cfg = ref_smoke(REF_ARCHS["granite-3-2b"])
    box = {}

    def only(key):
        p, s = ref_tf.init_params(ref_cfg, key)
        box["s"] = s
        return p

    sds = jax.eval_shape(only, jax.random.key(0))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, {"params": sds_zero(sds)},
                             specs={"params": box["s"]})
    ours = [(e["name"], e.get("spec")) for e in _manifest(path)]
    theirs = [(e["name"], e.get("spec"))
              for e in _manifest(tmp_path / "ref" / "step_00000005")]
    assert ours == theirs
    # the reference restores it onto a mesh, placing each leaf by its spec
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    got = ref_ckpt.restore_checkpoint(str(tmp_path), 5,
                                      {"params": sds}, mesh=mesh)
    for (name, leaf), arr in zip(ckpt._flatten_with_paths({"params": params}),
                                 jax.tree.leaves(got)):
        assert isinstance(arr.sharding, NamedSharding), name
        np.testing.assert_array_equal(np.asarray(arr), leaf.numpy())


def sds_zero(sds):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), sds)
