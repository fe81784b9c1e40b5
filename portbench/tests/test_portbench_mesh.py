"""A configuration's tp and the cell's cards: the mesh the harness builds,
the runs it refuses, the genome kept once per checkout, and the device
trace reduced card by card."""

import os
import shutil
import time

import numpy as np
import pytest

from portbench import devtrace, gen, harness


@pytest.mark.parametrize("cell,shape", [("t4.pe2x100", {"dp": 1, "tp": 4}),
                                        ("t2.pe2x100", {"dp": 1, "tp": 2})])
def test_tp_cell_runs_on_its_mesh(tiny_root, cell, shape):
    """A PE cell whose configuration states tp runs correct on a virtual
    mesh of as many CPU devices as the cell has cards, reporting pairs/s
    and set-up, through a backend of that mesh's shape."""
    result, info = harness.run_cell(tiny_root, cell, 4242424242, 1.0, False,
                                    "cpu", time.perf_counter())
    assert result["correct"], result["checked"]
    assert result["failed"] == 0 and result["attempted"] == info["fed"] > 0
    assert {"pairs_per_s", "setup_s"} <= set(result["metrics"])
    assert info["mesh"] == shape


def test_tp_that_does_not_divide_the_cards_is_refused(tiny_root):
    t0 = time.perf_counter()
    with pytest.raises(harness.Refusal, match="does not divide"):
        harness.run_cell(tiny_root, "t2.bad_tp", 1, 1.0, False, "cpu", t0)


class _Calls:
    def __init__(self):
        self.got = []

    def __call__(self, name, **kw):
        self.got.append((name, kw))
        return object()


@pytest.fixture
def backend_calls(monkeypatch):
    from walt_tpu_torch.core import backends

    calls = _Calls()
    monkeypatch.setattr(backends, "get_backend", calls)
    return calls.got


def test_one_card_builds_todays_backend(backend_calls):
    harness.make_backend(1, 1, "cuda")
    assert backend_calls == [("torch", dict(device="cuda:0", mesh=None,
                                            tp=1))]


@pytest.mark.parametrize("chips,tp,rows", [
    (4, 4, [["cuda:0", "cuda:1", "cuda:2", "cuda:3"]]),
    (4, 2, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (4, 1, [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]]),
    (2, 2, [["cuda:0", "cuda:1"]])])
def test_cards_make_the_ports_mesh(backend_calls, chips, tp, rows):
    """The cell's cards cuda:0 .. cuda:C-1, tp-major within a dp row, as
    ``sharded.make_mesh`` lays them out."""
    harness.make_backend(chips, tp, "cuda")
    (name, kw), = backend_calls
    assert name == "torch" and kw["device"] == "cuda:0" and kw["tp"] == tp
    assert [[str(d) for d in row] for row in kw["mesh"].devices] == rows


@pytest.mark.parametrize("tp", [0, -2, 1.5, "4"])
def test_a_tp_that_is_no_whole_number_is_refused(tp):
    with pytest.raises(harness.Refusal):
        harness.config_tp({"name": "x", "tp": tp})
    assert harness.config_tp({"name": "x"}) == 1


def test_genome_is_made_once_per_checkout(tiny_root, tmp_path, monkeypatch):
    """The first run makes the genome and keeps it beside the index; a
    later one loads it, byte for byte the generator's, without calling the
    generator; a directory without its ``ok`` marker is made again whole."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root, ignore=shutil.ignore_patterns("cache"))
    spec = harness.load_spec(root)
    _, config, _ = harness.find_cell(root, spec, "t.pe2x100")
    fresh = harness.make_genome(config)
    marks = []
    made, index = harness.prepare_inputs(root, config, marks.append)
    assert marks == ["genome", "index"]
    d = os.path.dirname(index)
    assert os.path.exists(os.path.join(d, "ok"))

    def generator(*a, **k):
        raise AssertionError("the generator ran again")

    monkeypatch.setattr(gen, "make_genome_repetitive", generator)
    loaded, again = harness.prepare_inputs(root, config)
    assert again == index
    for g in (made, loaded):
        assert g.names == fresh.names
        for field in ("seq", "start_index", "lengths"):
            a, b = getattr(g, field), getattr(fresh, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field
    monkeypatch.undo()
    os.remove(os.path.join(d, "ok"))
    with open(os.path.join(d, "stale"), "w") as f:
        f.write("left by a run that was cut")
    remade, _ = harness.prepare_inputs(root, config)
    assert not os.path.exists(os.path.join(d, "stale"))
    assert remade.seq.tobytes() == fresh.seq.tobytes()


def _reduce_as_one_union(events, w0, w1, spans, top=10):
    """The reduction before it went card by card: one union of every
    device event, whatever card it ran on."""
    by_name, iv = {}, []
    for name, _, s, z in events:
        s, z = max(s, w0), min(z, w1)
        if z <= s:
            continue
        iv.append((s, z))
        by_name[name] = by_name.get(name, 0) + (z - s)
    busy = devtrace._union(iv)
    busy_ns = sum(z - s for s, z in busy)
    gaps, prev = [], w0
    for s, z in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, z)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, z in gaps[:top]:
        mid = (s + z) // 2
        names = sorted({n for n, a, b, _ in spans.items if a <= mid < b})
        labelled.append(["+".join(names) or "no span", (z - s) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                device_ns_by_name=by_name,
                breakdown=dict(device_ops=[[n[:200], v / 1e9]
                                           for n, v in ops[:top]],
                               idle_gaps=labelled))


def _spans():
    spans = devtrace.Spans()
    spans.items += [("host_parse", 350, 700, 1), ("host_emit", 0, 120, 1)]
    return spans


def test_trace_is_reduced_card_by_card():
    events = [("k1", 0, 100, 200), ("k2", 0, 150, 300), ("k1", 1, 250, 400),
              ("k3", 1, 500, 600), ("k3", 1, 990, 1500), ("k2", 0, -50, 0)]
    got = devtrace.reduce_events(events, 0, 1000, _spans(), [0, 1])
    assert got["busy_s_by_card"] == {"cuda:0": 200 / 1e9,
                                     "cuda:1": 260 / 1e9}
    assert got["busy_s"] == 460 / 2e9
    assert got["window_s"] == 1000 / 1e9
    assert got["device_ns_by_name"] == {"k1": 250, "k2": 150, "k3": 110}
    # idle only where no card is busy: [0, 100), [400, 500), [600, 990)
    assert got["breakdown"]["idle_gaps"] == [["no span", 390 / 1e9],
                                             ["host_emit", 100 / 1e9],
                                             ["host_parse", 100 / 1e9]]
    # a card of the run that ran nothing counts, idle, in the mean
    idle = devtrace.reduce_events(events, 0, 1000, _spans(), [0, 1, 2, 3])
    assert idle["busy_s"] == 460 / 4e9
    assert idle["busy_s_by_card"]["cuda:3"] == 0


def test_one_card_reduces_as_before():
    rng = np.random.default_rng(3)
    starts = rng.integers(-200, 20_000, 500)
    events = [(f"k{int(k)}", 0, int(s), int(s + d)) for s, d, k in
              zip(starts, rng.integers(1, 400, 500), rng.integers(0, 7, 500))]
    for cards in ([0], []):
        got = devtrace.reduce_events(events, 0, 20_000, _spans(), cards)
        want = _reduce_as_one_union(events, 0, 20_000, _spans())
        assert {k: got[k] for k in want} == want
        assert got["busy_s_by_card"] == {"cuda:0": want["busy_s"]}
