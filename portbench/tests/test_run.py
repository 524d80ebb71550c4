"""Whole runs on the CPU at a tiny size: the result line's schema, the check
against planted faults, the modules a run loads, and BENCHMARK.json against
the benchmark's contract."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import cells, harness

from bench_cells import ROOT, tiny_cell

CPU = torch.device("cpu")
CELLS = ["fs-km32.stream-1080p", "fs-km256.stream-1080p", "fs-km256.image-1080p"]


def run_tiny(bench, name, trace=False, seconds=0.6, seed=2**31 + 11):
    cell = tiny_cell(name)
    return harness.run(bench, cell, seed, seconds, trace, CPU, time.perf_counter(), 0.0)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(bench, name, trace):
    result, lines = run_tiny(bench, name, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    json.dumps(result, allow_nan=False)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    cell = cells.find_cell(bench, name)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= set(cell.per_layer)
    else:
        # No card here: the metrics read from the card's trace are left out.
        sources = {m["name"]: m["source"] for m in bench["end_to_end"]}
        assert set(result["metrics"]) == {n for n in cell.end_to_end
                                          if sources[n] == "host_clock"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    for m, v in result["metrics"].items():
        assert v["unit"] == units[m] and isinstance(v["value"], float)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    assert any(line.startswith("setup ") for line in lines)


def _frames_unchanged(self, arrs, planar=False):
    return np.array(arrs, copy=True)


def _half_batch_left_out(original):
    def broken(self, arrs, planar=False):
        out = original(self, arrs, planar)
        half = len(arrs) // 2
        out[half:] = arrs[half:]
        return out
    return broken


def _one_pixel_altered(original):
    def broken(col, s, h, w, *args, **kwargs):
        out = original(col, s, h, w, *args, **kwargs)
        out[..., -1, -1, :] ^= 1
        return out
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out",
                                   "an answer altered where it is produced"])
def test_planted_faults_come_out_not_correct(bench, monkeypatch, name, fault):
    from dither_pie_tpu_torch.api import ditherer as api
    from dither_pie_tpu_torch.ops import wavefront

    image = "image" in name
    if fault == "state unchanged":
        if image:
            monkeypatch.setattr(api.ImageDitherer, "apply_dithering",
                                lambda self, img: img.copy())
        else:
            monkeypatch.setattr(api.ImageDitherer, "apply_dithering_batch", _frames_unchanged)
    elif fault == "half the batch left out":
        if image:
            pytest.skip("a call carries one image: there is no batch to halve")
        monkeypatch.setattr(api.ImageDitherer, "apply_dithering_batch",
                            _half_batch_left_out(api.ImageDitherer.apply_dithering_batch))
    else:
        monkeypatch.setattr(wavefront, "unskew_unpack",
                            _one_pixel_altered(wavefront.unskew_unpack))
    result, _ = run_tiny(bench, name)
    assert result["correct"] is False
    assert result["checks"]["mismatch_share"]["value"] > 0


def test_a_patched_frame_counts_as_failed(bench, monkeypatch):
    from dither_pie_tpu_torch.api import ditherer as api

    original = api.ImageDitherer.apply_dithering_batch
    calls = {"n": 0}

    def flaky(self, arrs, planar=False):
        calls["n"] += 1
        if len(arrs) == 1 and calls["n"] > 4:
            raise RuntimeError("planted")
        if len(arrs) > 1 and calls["n"] > 3:
            raise RuntimeError("planted")
        return original(self, arrs, planar)

    monkeypatch.setattr(api.ImageDitherer, "apply_dithering_batch", flaky)
    result, _ = run_tiny(bench, "fs-km32.stream-1080p")
    assert result["failed"] > 0 and result["correct"] is False
    assert result["checks"]["frames_patched"]["value"] > 0


def test_a_run_loads_no_jax_and_no_jax_package():
    script = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from portbench import cells, harness\n"
        "from bench_cells import tiny_cell\n"
        "for name in ('fs-km32.stream-1080p', 'fs-km256.image-1080p'):\n"
        "    harness.run(cells.load_benchmark(), tiny_cell(name), 5, 0.3, True,\n"
        "                torch.device('cpu'), time.perf_counter(), 0.0)\n"
        "tops = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'dither_pie_tpu'}))\n"
        "print('dither_pie_tpu_torch' in tops, harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "True []"]


def test_forbidden_names_are_compared_whole():
    sys.modules["dither_pie_tpu_torch_like_name"] = sys  # a name that only begins alike
    try:
        assert "dither_pie_tpu_torch_like_name" not in harness.forbidden_loaded()
    finally:
        del sys.modules["dither_pie_tpu_torch_like_name"]


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    # A full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, inside 43200 s.
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert all(_one_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
    assert len({c["source"] for c in bench["configs"]}) == len(configs)
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for cell in cells:
        reported = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    names = [c["name"] for c in bench["configs"]] + cells + list(e2e) + \
        [m["name"] for m in bench["per_layer"]]
    assert len(names) == len(set(names))


def test_kinds_and_references_are_found_by_name(bench):
    from portbench import cells

    kind_api = ("setup", "warm", "window", "end_to_end", "latencies", "failed", "counters",
                "profile", "scan_launch")
    ref_api = ("palette", "palette_checks", "outputs", "scan_work")
    for name in [w["name"] for w in bench["workloads"]]:
        cell = cells.find_cell(bench, name)
        kind = cells.load_module("kinds", cell.traffic["kind"])
        ref = cells.load_module("references", cell.config["reference"])
        assert all(callable(getattr(kind, f)) for f in kind_api), name
        assert all(callable(getattr(ref, f)) for f in ref_api), name
        assert cells.environment(cell.config) == {}
    with pytest.raises(cells.RunError):
        cells.load_module("kinds", "no-such-kind")


def test_a_configurations_env_must_map_names_to_strings():
    from portbench import cells

    assert cells.environment({"env": {"DITHER_PIE_TPU_X": "1"}}) == {"DITHER_PIE_TPU_X": "1"}
    assert cells.environment({}) == {}
    with pytest.raises(cells.RunError):
        cells.environment({"env": {"DITHER_PIE_TPU_X": 1}})


def test_the_command_scrubs_the_programs_switches_and_sets_the_configurations(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("with a card the command would run the whole cell")
    from portbench import cells
    monkeypatch.syspath_prepend(str(ROOT / "portbench"))
    import run as command

    cell = tiny_cell(CELLS[0])
    cell.config["env"] = {"DITHER_PIE_TPU_SET_BY_CONFIG": "yes"}
    monkeypatch.setattr(cells, "find_cell", lambda bench, name: cell)
    monkeypatch.setenv("DITHER_PIE_TPU_LEFT_OVER", "1")
    monkeypatch.setenv("DITHER_PIE_TPU_SET_BY_CONFIG", "no")
    rc = command.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    import os
    assert rc != 0  # no card here
    assert "DITHER_PIE_TPU_LEFT_OVER" not in os.environ
    assert os.environ["DITHER_PIE_TPU_SET_BY_CONFIG"] == "yes"


def test_host_lines_read_this_process():
    from portbench import hoststate

    line = hoststate.placement(CPU)
    assert line.startswith("host cpus=") and "card_node=none" in line
    before = hoststate.snapshot()
    _ = np.ones((256, 1024, 64)).sum()  # touch fresh pages
    after = hoststate.snapshot()
    line = hoststate.window_line(before, after, 4)
    assert line.startswith("host window_s=") and "minflt_per_frame=" in line
    assert after["minflt"] >= before["minflt"]


def test_a_run_prints_its_host_and_build_lines(bench):
    _, lines = run_tiny(bench, CELLS[0])
    assert sum(line.startswith("host ") for line in lines) == 2
    assert not any(line.startswith("build ") for line in lines)  # no card: no build
