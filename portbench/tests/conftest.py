"""A tiny copy of the benchmark for the CPU tests: the harness's files,
small configurations (patterns 3 and 7, three sequences of 550 kbp in all;
pattern 3 also at tp = 2 and tp = 4) and the four traffic mixes at a few
thousand reads, with the metric readers, under a BENCHMARK.json of its
own.  The tp cells run on a virtual mesh of CPU devices, one per card the
cell states."""

import json
import os
import shutil

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

TINY_CELLS = {"t.se100": ("tiny_p3", "se100"), "t.pe2x100": ("tiny_p3",
                                                              "pe2x100"),
              "t.se_trim": ("tiny_p7", "se_trim"),
              "t.pe2x50": ("tiny_p7", "pe2x50")}
#: cells over several (virtual) cards: cell -> (configuration, traffic,
#: chips); the last states a tp that does not divide its cards
MESH_CELLS = {"t4.pe2x100": ("tiny_p3_tp4", "pe2x100", 4),
              "t2.pe2x100": ("tiny_p3_tp2", "pe2x100", 2),
              "t2.bad_tp": ("tiny_p3_tp4", "pe2x100", 2)}


def make_tiny_root(root: str) -> str:
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("cache", "tests",
                                                  "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cfg_dir = os.path.join(root, "portbench", "configs")
    configs = []
    for name, pattern, tp in (("tiny_p3", "3", None), ("tiny_p7", "7", None),
                              ("tiny_p3_tp2", "3", 2),
                              ("tiny_p3_tp4", "3", 4)):
        with open(os.path.join(cfg_dir, f"athal_p{pattern}.json")) as f:
            cfg = json.load(f)
        cfg.update(name=name, genome=dict(names=["c1", "c2", "c3"],
                                          lengths=[300000, 200000, 50000],
                                          seed=42))
        if tp is not None:
            cfg["tp"] = tp
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        configs.append(dict(name=name, source="tiny", file=path, reduced=[],
                            why="CPU tests"))
    cells = []
    for cell, (config, traffic) in TINY_CELLS.items():
        t_path = os.path.join(root, "portbench", "traffic",
                              f"{traffic}.json")
        with open(t_path) as f:
            t = json.load(f)
        t.update(batch=2000, pool=6000, sample=120, warm_batches=1)
        with open(os.path.join(root, "portbench", "traffic",
                               f"tiny_{traffic}.json"), "w") as f:
            json.dump(t, f)
        cells.append(dict(name=cell, config=config, traffic=f"tiny_{traffic}",
                          chips=1, why="CPU tests"))
    for cell, (config, traffic, chips) in MESH_CELLS.items():
        cells.append(dict(name=cell, config=config, traffic=f"tiny_{traffic}",
                          chips=chips, why="CPU tests"))
    se = [c for c in TINY_CELLS if "se" in TINY_CELLS[c][1]]
    pe = [c for c in TINY_CELLS if "pe" in TINY_CELLS[c][1]] + list(
        MESH_CELLS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            se_m = any(w.endswith((".se100", ".se_trim"))
                       for w in m["workloads"])
            m["workloads"] = se if se_m else pe
    # the SE readers kept under metrics/ for the SE cells' return, given
    # entries here when BENCHMARK.json has none
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    if "reads_per_s" not in names:
        spec["end_to_end"].append(dict(
            name="reads_per_s", unit="reads/s", better="higher", bound=0.25,
            source="host_clock", workloads=se))
    mdir = os.path.join(PKG, "metrics")
    for f in sorted(os.listdir(mdir)):
        name = f[:-3]
        if f.endswith(".se.py") and name not in names:
            spec["per_layer"].append(dict(
                name=name, unit="x", better="lower", source="program_span",
                layer="t", moves="reads_per_s", workloads=se))
    spec.update(configs=configs, workloads=cells)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))
