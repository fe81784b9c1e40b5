"""The benchmark's inputs, made from seeds: genome, reads, pairs, FASTQ.

Frozen copies of the generators the port's smoke test used (the repetitive
genome, bisulfite SE reads and read pairs, the 3'-trimmed short-read mix),
so that the yardstick stays put when the program's own copies change.  The
genome takes a list of sequence lengths; given equal lengths it is the
program's ``make_genome_repetitive`` base for base.

Codes: A=0 C=1 G=2 T=3.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8).copy()


@dataclasses.dataclass
class Genome:
    names: list
    lengths: np.ndarray  # uint32 (n_chroms,)
    start_index: np.ndarray  # uint32 (n_chroms + 1,)
    seq: np.ndarray  # uint8 codes

    @property
    def n_chroms(self) -> int:
        return len(self.names)

    @property
    def length_of_genome(self) -> int:
        return int(self.seq.shape[0])


def make_genome(lengths, names, seed: int) -> Genome:
    """Random ACGT sequences of the given lengths, concatenated."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.uint32)
    n_bases = int(lengths.astype(np.int64).sum())
    start = np.zeros(lengths.shape[0] + 1, dtype=np.uint32)
    np.cumsum(lengths, out=start[1:])
    seq = rng.integers(0, 4, n_bases, dtype=np.uint8)
    return Genome(names=list(names), lengths=lengths, start_index=start,
                  seq=seq)


def make_genome_repetitive(lengths, names, seed: int) -> Genome:
    """A genome with planted repeat families (SINE-, LINE- and MIR-like
    copies at 5-35% divergence, microsatellite runs, one alpha-satellite-like
    tandem array per sequence), which give the bucket-size tail that sets a
    bisulfite mapper's cost."""
    rng = np.random.default_rng(seed)
    g = make_genome(lengths, names, seed)
    n_bases = g.length_of_genome
    seq = g.seq

    def plant(master, density, div_lo, div_hi, truncate):
        L = master.shape[0]
        total = int(n_bases * density)
        n_copies = max(1, total // max(L // (2 if truncate else 1), 1))
        starts = rng.integers(0, max(1, n_bases - L), n_copies)
        lens = (rng.integers(L // 10, L + 1, n_copies) if truncate
                else np.full(n_copies, L))
        divs = rng.uniform(div_lo, div_hi, n_copies)
        for s, ln, dv in zip(starts, lens, divs):
            copy = master[L - ln:].copy()
            mut = rng.random(ln) < dv
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            seq[s: s + ln] = copy

    plant(rng.integers(0, 4, 300, dtype=np.uint8), 0.10, 0.05, 0.25, True)
    plant(rng.integers(0, 4, 6000, dtype=np.uint8), 0.17, 0.05, 0.30, True)
    plant(rng.integers(0, 4, 200, dtype=np.uint8), 0.03, 0.20, 0.35, True)
    units = [np.array(u, dtype=np.uint8)
             for u in ([0, 3], [1, 0], [1, 0, 2], [3, 3, 1, 0])]
    n_runs = max(4, n_bases // 200_000)
    for _ in range(n_runs):
        unit = units[int(rng.integers(0, len(units)))]
        ln = int(rng.integers(50, 2000))
        s = int(rng.integers(0, max(1, n_bases - ln)))
        run = np.tile(unit, ln // len(unit) + 1)[:ln]
        mut = rng.random(ln) < 0.02
        run[mut] = (run[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        seq[s: s + ln] = run
    alpha = rng.integers(0, 4, 171, dtype=np.uint8)
    for c in range(g.n_chroms):
        a = int(g.start_index[c])
        z = int(g.start_index[c + 1])
        ln = min(max(2000, (z - a) // 200), z - a)
        s = a + (z - a - ln) // 2
        arr = np.tile(alpha, ln // 171 + 1)[:ln]
        mut = rng.random(ln) < 0.05
        arr[mut] = (arr[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        seq[s: s + ln] = arr
    return g


#: the fields of a saved genome, each ``genome.<field>.npy`` in its
#: directory
GENOME_FIELDS = ("seq", "start_index", "lengths", "names")


def save_genome(genome: Genome, d: str) -> None:
    """Write ``genome`` into directory ``d``, one ``.npy`` array per field
    (codes, start index and lengths in their own dtypes, the names as a
    string array), which :func:`load_genome` reads back in seconds."""
    for field in GENOME_FIELDS:
        value = getattr(genome, field)
        np.save(f"{d}/genome.{field}.npy",
                np.array(value, dtype=str) if field == "names" else value)


def load_genome(d: str) -> Genome:
    """The genome :func:`save_genome` wrote into ``d``, read whole."""
    got = {f: np.load(f"{d}/genome.{f}.npy") for f in GENOME_FIELDS}
    got["names"] = [str(n) for n in got["names"]]
    return Genome(**got)


def write_fasta(genome: Genome, path: str, width: int = 70) -> None:
    with open(path, "wb") as f:
        for i, name in enumerate(genome.names):
            a, b = int(genome.start_index[i]), int(genome.start_index[i + 1])
            text = CODE_TO_BASE[genome.seq[a:b]]
            n = text.shape[0]
            rows = -(-n // width)
            grid = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
            pad = rows * width - n
            grid[:, :width] = np.pad(text, (0, pad)).reshape(rows, width)
            f.write(b">" + name.encode() + b"\n")
            tail = grid.tobytes()
            if pad:
                tail = tail[: -(pad + 1)] + b"\n"
            f.write(tail)


def sample_reads(genome: Genome, n: int, length: int, seed,
                 bis_rate: float = 0.75, err_rate: float = 0.01):
    """Bisulfite SE reads from both strands: (codes (n, length), lens,
    starts)."""
    rng = np.random.default_rng(seed)
    G = genome.length_of_genome
    starts = rng.integers(0, G - length, n)
    chrom = np.searchsorted(genome.start_index, starts, side="right") - 1
    ends = genome.start_index.astype(np.int64)[chrom + 1]
    starts = np.minimum(starts, ends - length)
    codes = genome.seq[starts[:, None] + np.arange(length)].copy()
    rev = rng.integers(0, 2, n).astype(bool)
    codes[rev] = (3 - codes[rev])[:, ::-1]
    is_c = codes == 1
    codes[is_c & (rng.random((n, length)) < bis_rate)] = 3
    err = rng.random((n, length)) < err_rate
    codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()))) % 4
    lens = np.full(n, length, dtype=np.int32)
    return codes, lens, starts


def sample_pairs(genome: Genome, n: int, length: int, seed,
                 frag_lo: int = 150, frag_hi: int = 500,
                 bis_rate: float = 0.75, err_rate: float = 0.01):
    """Bisulfite read pairs: mate 1 the fragment's 5' end (C->T world),
    mate 2 the reverse complement of its 3' end.  (codes1, lens1, codes2,
    lens2)."""
    rng = np.random.default_rng(seed)
    G = genome.length_of_genome
    frag_len = rng.integers(frag_lo, frag_hi + 1, n)
    starts = rng.integers(0, G - frag_hi, n)
    chrom = np.searchsorted(genome.start_index, starts, side="right") - 1
    ends = genome.start_index.astype(np.int64)[chrom + 1]
    starts = np.minimum(starts, ends - frag_len)
    c1 = genome.seq[starts[:, None] + np.arange(length)].copy()
    s2 = starts + frag_len - length
    c2 = genome.seq[s2[:, None] + np.arange(length)].copy()
    for c in (c1, c2):
        is_c = c == 1
        c[is_c & (rng.random((n, length)) < bis_rate)] = 3
    c2 = (3 - c2)[:, ::-1]
    for c in (c1, c2):
        err = rng.random((n, length)) < err_rate
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
    lens = np.full(n, length, dtype=np.int32)
    return c1, lens, np.ascontiguousarray(c2), lens.copy()


def trimmed_lengths(n: int, classes, seed) -> np.ndarray:
    """3' trimming: each class ``[lo, hi, share]`` gives round(share * n)
    reads a length uniform over lo..hi (the last class takes the rest), in
    an order drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    counts = [int(round(share * n)) for _, _, share in classes[:-1]]
    counts.append(n - sum(counts))
    lens = np.concatenate([rng.integers(lo, hi + 1, k)
                           for (lo, hi, _), k in zip(classes, counts)])
    return rng.permutation(lens).astype(np.int32)


#: digits of a read's number in its name, ``r`` and nine digits
NAME_DIGITS = 9


def read_name(i: int) -> str:
    return f"r{i:0{NAME_DIGITS}d}"


def fastq_records(codes: np.ndarray, lens: np.ndarray):
    """FASTQ text of reads ``read_name(i)`` (bases ``codes[i, :lens[i]]``,
    quality all 'I') as one bytes object, with each record's start offset
    ((n + 1,), the last the total size)."""
    n, L = codes.shape
    lens = np.asarray(lens, dtype=np.int64)
    head = 2 + NAME_DIGITS + 1  # "@r" + digits + "\n"
    width = head + L + 3 + L + 1
    grid = np.empty((n, width), dtype=np.uint8)
    grid[:, 0:2] = np.frombuffer(b"@r", dtype=np.uint8)
    pw = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    grid[:, 2:2 + NAME_DIGITS] = (np.arange(n, dtype=np.int64)[:, None]
                                  // pw) % 10 + 48
    grid[:, head - 1] = 10
    grid[:, head: head + L] = CODE_TO_BASE[codes]
    grid[:, head + L: head + L + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    grid[:, head + L + 3: width - 1] = ord("I")
    grid[:, width - 1] = 10
    keep = np.ones((n, width), dtype=bool)
    short = lens < L
    if short.any():
        j = np.arange(L)
        cut = j[None, :] >= lens[short][:, None]
        rows = np.flatnonzero(short)[:, None]
        keep[rows, head + j] = ~cut
        keep[rows, head + L + 3 + j] = ~cut
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(head + 2 * lens + 4, out=off[1:])
    text = grid[keep].tobytes() if short.any() else grid.tobytes()
    return text, off
