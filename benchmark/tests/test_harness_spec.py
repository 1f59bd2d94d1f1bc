"""BENCHMARK.json and the files it names: every configuration, mix, limit
file and per-layer reader parses and is found by name."""

import json
import re

import pytest

from harness import peaks, spec as spec_mod, traffic
from reference.pathtracer import parse_scene

SPEC = spec_mod.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[k]]
        assert len(got) == len(set(got))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_found_and_parses(entry):
    from terminal_raytracer_tpu_torch.models import scene_from_dict

    cfg = spec_mod.load_config(SPEC, entry["name"])
    assert entry["file"].startswith("benchmark/configs/")
    scene = scene_from_dict(cfg)
    ref = parse_scene(cfg)
    assert (ref.width, ref.height, ref.spp, ref.max_depth) == (
        scene.width, scene.height, scene.samples_per_pixel, scene.max_depth)
    assert ref.counts == (len(scene.spheres), len(scene.planes),
                          len(scene.triangles))
    assert set(entry["reduced"]) <= set(cfg)
    assert spec_mod.load_limits(entry["name"])
    assert peaks.ops_per_sweep(cfg) > 0


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_found(wl):
    assert spec_mod.workload(SPEC, wl["name"]) is wl
    spec_mod.config_entry(SPEC, wl["config"])
    traffic.check_mix(spec_mod.load_mix(wl["traffic"]))
    assert wl["chips"] in (1, 4)
    e2e = [m["name"] for m in spec_mod.metrics_for(SPEC, wl["name"],
                                                   "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec_mod.metrics_for(SPEC, wl["name"], "per_layer")


def test_pairs_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(m):
    assert spec_mod.reader_path(m["name"]).exists()
    assert callable(spec_mod.load_reader(m["name"]))
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    for wl in m["workloads"]:
        assert wl in e2e[m["moves"]].get("workloads", [wl])
    if m["name"].split(".")[0].endswith("_roofline"):
        assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"viewer loop", "display encode",
                      "render step, host side", "kernels A and B", "device"}


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        spec_mod.workload(SPEC, "no.such")
    with pytest.raises(FileNotFoundError):
        spec_mod.load_mix("no_such_mix")
