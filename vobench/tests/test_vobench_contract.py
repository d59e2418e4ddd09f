"""BENCHMARK.json against the benchmark's contract, the files it names,
and the rule that nothing the harness or its reference loads is JAX or
the JAX package (by whole top-level name: tpu_vo_torch is not tpu_vo)."""

import ast
import json
import os
import re
import subprocess
import sys

from vobench import check, harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vobench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and w["name"].startswith(w["config"] + ".")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_has_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert c["file"].startswith("vobench/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "vobench", "scenes", cfg["scene"]["kind"] + ".py"))
    for w in BENCH["workloads"]:
        for path in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(harness.HERE, path)), path
        cell = harness.load_cell(w["name"])
        assert all(k in cell.limits for k in check.names(cell.traffic["stages"]))
        assert callable(harness.reference_run(cell.config))
    for kind, metrics in (("end_to_end", BENCH["end_to_end"]), ("metrics", BENCH["per_layer"])):
        for m in metrics:
            assert callable(harness._reader(kind, m["name"]))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for d, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(d, f)):
                    assert mod.split(".")[0] not in harness.FORBIDDEN, (f, mod)
    ref = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] != "tpu_vo_torch", (f, mod)


def test_a_run_loads_no_jax_module():
    """A whole cut-down run in a fresh process, then its sys.modules."""
    code = (
        "import sys, time, torch; torch.set_num_threads(2)\n"
        "from vobench import harness\n"
        "ov = dict(image_width=160, image_height=120, n_features=64, n_levels=2, max_iters=8,"
        " call_shape=[3], pool=1, check_calls=1, ref_block=3)\n"
        "line = harness.run_cell('kitti_orb1200.seq128', 5, 0.1, False, time.time(),"
        " device='cpu', overrides=ov)\n"
        "assert line['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "tpu_vo_torch" in top and not top & set(harness.FORBIDDEN)


def test_the_command_refuses_without_a_card():
    """On a host with no card the command exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, "-m", "vobench.run", "--workload",
                          "kitti_orb1200.seq128", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and not out.stdout.strip()
