"""The frozen copies against the program's originals on small seeded
inputs, and the plain reference against the port's exact host path."""

import json
import os

import numpy as np
import pytest

from portbench import gen, harness, outcheck, reference, roofline

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_genome_copy_is_the_programs():
    from walt_tpu_torch import synth

    for n, k, seed in ((200_000, 2, 42), (90_001, 3, 7)):
        want = synth.make_genome_repetitive(n, n_chroms=k, seed=seed)
        got = gen.make_genome_repetitive(want.lengths, want.names, seed)
        assert np.array_equal(got.seq, want.seq)
        assert np.array_equal(got.start_index, want.start_index)


def test_read_and_pair_copies_are_the_programs():
    from walt_tpu_torch import synth

    g = synth.make_genome_repetitive(300_000, n_chroms=2, seed=5)
    mine = gen.make_genome_repetitive(g.lengths, g.names, 5)
    for a, b in zip(gen.sample_reads(mine, 500, 100, 3),
                    synth.sample_reads(g, 500, 100, seed=3)):
        assert np.array_equal(a, b)
    for a, b in zip(gen.sample_pairs(mine, 400, 50, 9, 100, 300),
                    synth.sample_pairs(g, 400, 50, seed=9, frag_lo=100,
                                       frag_hi=300)):
        assert np.array_equal(a, b)


def test_fastq_text_parses_as_the_driver_reads_it():
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (300, 60), dtype=np.uint8)
    lens = gen.trimmed_lengths(300, [[23, 60, 0.9], [15, 22, 0.1]], 4)
    text, off = gen.fastq_records(codes, lens)
    assert off[-1] == len(text)
    s = harness.BatchStream(text, off, 100, max_batches=5)
    lines = FgetsLines(s)
    seen = 0
    while True:
        b = load_batch(lines, 100)
        if not len(b):
            break
        c, ln = b.packed()
        for j in range(len(b)):
            i = (seen + j) % 300
            assert b.names[j] == gen.read_name(i)
            assert np.array_equal(c[j, :ln[j]], codes[i, :lens[i]])
        seen += len(b)
    assert seen == 500 and s.fed == 500


def test_trimmed_lengths_classes():
    lens = gen.trimmed_lengths(10_000, [[23, 100, 0.99], [15, 22, 0.01]], 1)
    assert (lens < 23).sum() == 100
    assert lens.min() >= 15 and lens.max() <= 100


def test_roofline_copy_is_the_smoke_tests():
    import torch

    import chip_smoke

    assert roofline.bound(1e9, 1e12) == chip_smoke.bound(1e9, 1e12)
    g = torch.Generator().manual_seed(0)
    M, W = 64, 7
    index = torch.randint(0, 1 << 20, (4096,), generator=g, dtype=torch.int32)
    args = (torch.randint(0, 50, (M,), generator=g),
            torch.randint(0, 3, (M,), generator=g),
            torch.randint(0, 4096, (M,), generator=g), None,
            torch.zeros((50, W), dtype=torch.int64), None, None, index,
            torch.zeros(1 << 16, dtype=torch.int32),
            torch.tensor([0, 1 << 19, 1 << 20]))
    kw = {"seeds": (0, 1, 2)}
    assert roofline.stage_bound(args, kw) == chip_smoke.stage_bound(args, kw)
    pseq = torch.zeros(1 << 16, dtype=torch.int32)
    wargs = (pseq, torch.randint(0, 1 << 20, (M,), generator=g,
                                 dtype=torch.int32), None, None)
    assert roofline.windows_bound(wargs, W) == chip_smoke.windows_bound(
        wargs, W)


def _exact_host_outputs(root, cell, n, tmp):
    """The port's exact host path (its numpy backend, as ``--backend
    numpy`` runs it) over the first ``n`` reads of the tiny cell's pool."""
    from walt_tpu_torch.core.backends import get_backend
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    spec = harness.load_spec(root)
    _, config, traffic = harness.find_cell(root, spec, cell)
    traffic = dict(traffic, pool=n)
    genome, index = harness.prepare_inputs(root, config)
    pool = harness.Pool(genome, traffic, 77)
    paths = []
    for m, (text, _) in enumerate(pool.text):
        p = os.path.join(tmp, f"r{m}.fq")
        with open(p, "wb") as f:
            f.write(text)
        paths.append(p)
    out = os.path.join(tmp, "exact.mr")
    flags = config["flags"]
    common = dict(max_mismatches=flags["m"], b=flags["b"],
                  backend=get_backend("numpy"),
                  pattern_name=str(config["seed_pattern"]))
    open(out, "w").close()
    if traffic["mode"] == "pe":
        process_paired_end(index, paths[0], paths[1], out, top_k=flags["k"],
                           frag_range=flags["L"], **common)
    else:
        process_single_end(index, paths[0], out, **common)
    with open(out, "rb") as f:
        data = f.read()
    with open(out + ".mapstats") as f:
        stats = f.read()
    return genome, config, traffic, pool, data, stats


@pytest.mark.parametrize("cell", ["t.se100", "t.pe2x100", "t.se_trim",
                                  "t.pe2x50"])
def test_reference_agrees_with_the_exact_host_path(tiny_root, tmp_path,
                                                   cell):
    n = 300
    genome, config, traffic, pool, data, stats = _exact_host_outputs(
        tiny_root, cell, n, str(tmp_path))
    traffic = dict(traffic, sample=n)
    got = outcheck.check(genome, config, traffic, pool, data, stats, n, 77)
    assert got["correct"], got["numbers"]
    assert got["sampled"] == n
    assert got["unjudged"] <= n // 10


def test_reference_patterns_are_the_programs():
    from walt_tpu_torch.constants import get_pattern

    for name, mine in reference.PATTERNS.items():
        p = get_pattern(name)
        assert mine.cared == tuple(int(x) for x in p.cared)
        assert (mine.pattern_len, mine.cared_weight, mine.min_read_len,
                mine.min_seed_len, mine.exit1_seed) == (
            p.pattern_len, p.cared_weight, p.min_read_len, p.min_seed_len,
            p.exit1_seed)
        assert mine.verify_skip == tuple(p.verify_skip)
        assert mine.key_span == p.key_span


def test_configs_are_tair10_layout():
    for name in ("athal_p3", "athal_p7"):
        with open(os.path.join(REPO, "portbench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        assert sum(cfg["genome"]["lengths"]) == 119_667_750
        assert cfg["genome"]["names"][0] == "Chr1"
