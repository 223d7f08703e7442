"""A cell, a traffic mix and a metric added as new files (and entries in
BENCHMARK.json) in a copy of the benchmark are found without editing a
file that is there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    mix = json.loads((ROOT / "benchmark/traffic/lvis_b16.json").read_text())
    (tmp_path / "benchmark/traffic/lvis_b8.json").write_text(
        json.dumps(dict(mix, batch=8)))
    spec = json.loads(
        (ROOT / "benchmark/workloads/det_base_lvis_b16.json").read_text())
    (tmp_path / "benchmark/workloads/det_base_lvis_b8.json").write_text(
        json.dumps(spec))
    (tmp_path / "benchmark/metrics/det_calls.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    bench["workloads"].append({"name": "det_base_lvis_b8",
                               "config": "wedetect_base",
                               "traffic": "lvis_b8", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "det_calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "det_img_per_s",
                               "workloads": ["det_base_lvis_b8"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("det_"):
            m["workloads"].append("det_base_lvis_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import load_cell, reader, Run, ROOT\n"
        "assert str(ROOT) == %r, ROOT\n"
        "c = load_cell('det_base_lvis_b8')\n"
        "print(c.traffic['batch'], c.spec['entry'], c.config['name'],\n"
        "      ','.join(m['name'] for m in c.per_layer),\n"
        "      reader('det_calls')(Run(cell=c, calls=3)))\n"
        % (str(tmp_path), str(tmp_path)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[:4] == ["8", "detect", "wedetect_base",
                                    "det_calls"]
    assert r.stdout.split()[-1] == "3.0"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
