"""Cells, configurations, traffic mixes and metrics load by name, agree with
``BENCHMARK.json``, and a new cell needs only new files."""

import json
import math
import re
import shutil

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.traffic import Traffic, length_set

BENCH = harness.BENCH
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_loads_and_agrees(w):
    c = harness.cell(w["name"])
    assert (c["config"], c["traffic"], c["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    assert c["why"] == w["why"] and len(w["why"]) <= 200
    assert "sampler_mismatch" in c["limits"]
    assert set(c["limits"]) - {"sampler_mismatch"} <= {"decode_gap",
                                                       "decode_gap_mean"}
    fam = harness.load_module("families", c["spec"]["family"])
    assert fam.port_config(c["spec"]).vocab >= fam.prompt_vocab(c["spec"])
    harness.load_module("paths", c["path"])
    harness.load_module("reference", c["spec"]["family"])
    harness.load_module("flops", c["spec"]["family"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    """The file holds the published keys; ``reduced`` names only cuts, each
    beside its published value, and no width; what the port runs otherwise
    is a departure under ``assumed``, beside its published value, and the
    configuration as run takes it."""
    spec = json.loads((ROOT / c["file"]).read_text())
    assert spec["name"] == c["name"]
    assert spec["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in spec["published"] and spec[key] != spec["published"][key]
        assert not re.search(r"(_dim$|_rank$|hidden_size|intermediate_size|"
                             r"d_model|d_state|expand|headdim|"
                             r"experts_per_tok)", key), key
    assert c["file"].startswith("portbench/configs/")
    run = harness.config(c["name"])
    for key, d in spec["assumed"].get("departures", {}).items():
        assert key not in c["reduced"]
        assert spec[key] == d["published"] != d["runs"] == run[key]
        assert d["waits_on"]


def test_departure_must_match_the_published_key(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "configs" / "deepseek-v3-671b-5l.json"
    spec = json.loads(path.read_text())
    spec["n_group"] = 1  # the run value in place of the published one
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="n_group"):
        harness.config("deepseek-v3-671b-5l", root)


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_file(name):
    """A traffic file names its source and lists its cuts beside the
    source's values; its lengths are the same set for every seed."""
    t = harness.load_json("traffic", name)
    assert t["name"] == name and t["source"]
    assert "prompt_len" in t["reduced"]
    for cut in t["reduced"].values():
        assert {"source", "here", "why"} <= set(cut)
    a = Traffic(t, 2**33 + 7, 1000)
    b = Traffic(t, 12, 1000)
    assert sorted(a.asks(0)) == sorted(a.asks(3)) == sorted(b.asks(0))
    assert not np.array_equal(a.asks(0), b.asks(0))
    assert a.new_tokens == max(a.lengths) == t["new_tokens"]["max"]
    assert a.prompts(0).shape == (t["clients"], t["prompt_len"])


@pytest.mark.parametrize("top_p", [0.0, -0.1, 1.5, float("nan"), None])
def test_bad_top_p_refused(top_p):
    t = harness.load_json("traffic", "chat256-topp")
    assert (t["sampler"], t["top_p"], t["top_k"]) == ("topp", 0.9, 64)
    assert Traffic(t, 3, 1000).top_p == 0.9
    bad = dict(t, top_p=top_p)
    if top_p is None:
        del bad["top_p"]
    with pytest.raises(ValueError, match="top_p"):
        Traffic(bad, 3, 1000)


def test_length_set():
    spec = {"lognormal": {"median": 100, "sigma": 1.0}, "scale": 0.5, "max": 80}
    got = length_set(spec, 4)
    # quantiles 1/8, 3/8, 5/8, 7/8 of the normal: -1.1503, -0.3186, ...
    want = [min(80, max(1, round(50 * math.exp(z)))) for z in
            (-1.1503493803760079, -0.31863936396437514,
             0.31863936396437514, 1.1503493803760079)]
    assert got.tolist() == want == [16, 36, 69, 80]
    assert length_set(7, 3).tolist() == [7, 7, 7]


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_end_to_end_agrees(w):
    """The end-to-end metrics a cell's file names are those that
    ``BENCHMARK.json`` gives it, and every per-layer metric listed for it
    moves one of them."""
    names = harness.end_to_end(harness.cell(w["name"]))
    assert set(names) == {e["name"] for e in SPEC["end_to_end"]
                          if w["name"] in e.get("workloads", [w["name"]])}
    assert set(names) <= set(harness.E2E_UNITS)
    for e in SPEC["end_to_end"]:
        assert e["unit"] == harness.E2E_UNITS[e["name"]]
    for m in SPEC["per_layer"]:
        if w["name"] in m["workloads"]:
            assert m["moves"] in names, m["name"]


def test_metric_readers_match_benchmark():
    rd = harness.readers()
    assert sorted(rd) == sorted(m["name"] for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert rd[m["name"]].UNIT == m["unit"]
        assert callable(rd[m["name"]].read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}


def test_extra_cell_is_only_new_files(tmp_path):
    """A cell added as a new file (here a shorter mix on the mamba2 smoke
    width) loads and runs through the harness with no file edited."""
    root = tmp_path / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "tiny-greedy.json").write_text(json.dumps({
        "name": "tiny-greedy", "loop": "closed", "clients": 2, "prompt_len": 3,
        "new_tokens": 5, "prompt_tokens": "uniform", "sampler": "greedy"}))
    (root / "workloads" / "mamba2-tiny-greedy.json").write_text(json.dumps({
        "name": "mamba2-tiny-greedy", "config": "mamba2-2.7b",
        "traffic": "tiny-greedy", "path": "lockstep", "chips": 1,
        "limits": {"decode_gap": 0.5, "sampler_mismatch": 0},
        "why": "a test cell"}))
    c = harness.cell("mamba2-tiny-greedy", root)
    assert c["traffic_params"]["new_tokens"] == 5
    out = harness.run("mamba2-tiny-greedy", 5, 0.01, False, device="cpu",
                      smoke=True, root=root)
    assert out.result["correct"] and out.result["attempted"] >= 2


def test_bad_names_refused():
    for bad in ("../x", "a b", "a/b", ""):
        with pytest.raises(ValueError):
            harness.load_json("workloads", bad)


@pytest.mark.parametrize("top_p, top_k", [(0.95, 64), (0.9, 50), (None, 64)])
def test_lockstep_path_refuses_another_nucleus(top_p, top_k):
    """The lock-step decoder fixes its top-p nucleus; a mix that asks for
    another is refused before anything is built."""
    lockstep = harness.load_module("paths", "lockstep")
    with pytest.raises(ValueError, match="topp"):
        lockstep.Path(None, None, clients=2, max_len=4, sampler="topp",
                      top_k=top_k, top_p=top_p, seed=1,
                      device=torch.device("cpu"), clock=None)
