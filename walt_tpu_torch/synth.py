"""Synthetic genomes and bisulfite read batches.

Used by the benchmark harness, the driver entry points, and tests to build
workloads with a known planting structure (reads sampled from the genome,
bisulfite-converted C->T at a given rate, with sequencing errors), mirroring
the simulated-read methodology the reference was validated with
(doc/Supplementary Data, section 4).
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch.constants import SeedPattern, get_pattern
from walt_tpu_torch.genome import Genome


def make_genome(n_bases: int, n_chroms: int = 2, seed: int = 0) -> Genome:
    """Random ACGT genome as a Genome of 2-bit codes."""
    rng = np.random.default_rng(seed)
    lengths = np.full(n_chroms, n_bases // n_chroms, dtype=np.uint32)
    lengths[-1] += n_bases - int(lengths.sum())
    start = np.zeros(n_chroms + 1, dtype=np.uint32)
    np.cumsum(lengths, out=start[1:])
    seq = rng.integers(0, 4, n_bases, dtype=np.uint8)
    names = [f"chr{i + 1}" for i in range(n_chroms)]
    return Genome(names=names, lengths=lengths, start_index=start, seq=seq)


def make_genome_repetitive(n_bases: int, n_chroms: int = 2,
                           seed: int = 0) -> Genome:
    """Genome with a human-like repeat landscape for realistic bucket tails.

    A uniform-random genome gives almost-all-singleton hash buckets; real
    mapping cost is dominated by the repeat tail (87% of reads sit in
    size-1 buckets but the tail reaches the -b cap of 5000, reference
    supplement Table S2).  This plants the families that create that tail:

    - SINE ("Alu"-like): 300 bp master, ~10% of the genome, 5-25% per-copy
      divergence, frequent 5' truncation;
    - LINE ("L1"-like): 6 kbp master, ~17% of the genome, mostly truncated
      copies, 5-30% divergence;
    - old SINE ("MIR"-like): 200 bp master at high divergence (deep but
      resolvable buckets);
    - microsatellites ((AT)n / (CA)n / (CAG)n runs) and a 171 bp
      "alpha-satellite" tandem array -- the degenerate keys whose buckets
      blow past -b and, at genome scale, past the 500k erasure threshold
      (reference.cpp:211-218).
    """
    rng = np.random.default_rng(seed)
    g = make_genome(n_bases, n_chroms=n_chroms, seed=seed)
    seq = g.seq  # mutated in place

    def plant(master: np.ndarray, density: float, div_lo: float,
              div_hi: float, truncate: bool):
        L = master.shape[0]
        total = int(n_bases * density)
        n_copies = max(1, total // max(L // (2 if truncate else 1), 1))
        starts = rng.integers(0, max(1, n_bases - L), n_copies)
        lens = (
            rng.integers(L // 10, L + 1, n_copies) if truncate
            else np.full(n_copies, L)
        )
        divs = rng.uniform(div_lo, div_hi, n_copies)
        for s, ln, dv in zip(starts, lens, divs):
            copy = master[L - ln:].copy()  # 5' truncation keeps the 3' end
            mut = rng.random(ln) < dv
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            seq[s : s + ln] = copy

    plant(rng.integers(0, 4, 300, dtype=np.uint8), 0.10, 0.05, 0.25, True)
    plant(rng.integers(0, 4, 6000, dtype=np.uint8), 0.17, 0.05, 0.30, True)
    plant(rng.integers(0, 4, 200, dtype=np.uint8), 0.03, 0.20, 0.35, True)

    # tandem repeats: microsatellite runs + one alpha-satellite-like array
    # per chromosome (perfectly periodic cores whose buckets degenerate)
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
        seq[s : s + ln] = run
    alpha = rng.integers(0, 4, 171, dtype=np.uint8)
    for c in range(g.n_chroms):
        a = int(g.start_index[c])
        z = int(g.start_index[c + 1])
        ln = min(max(2000, (z - a) // 200), z - a)
        s = a + (z - a - ln) // 2
        arr = np.tile(alpha, ln // 171 + 1)[:ln]
        mut = rng.random(ln) < 0.05
        arr[mut] = (arr[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        seq[s : s + ln] = arr
    return g


def write_genome_fasta(genome: Genome, path: str, width: int = 70) -> None:
    from walt_tpu_torch.constants import CODE_TO_BASE

    with open(path, "wb") as f:
        for i, name in enumerate(genome.names):
            a, b = int(genome.start_index[i]), int(genome.start_index[i + 1])
            text = CODE_TO_BASE[genome.seq[a:b]]
            n = text.shape[0]
            rows = -(-n // width)
            # vectorized line wrapping: (rows, width+1) byte grid with the
            # newline column prefilled
            grid = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
            pad = rows * width - n
            grid[:, :width] = np.pad(text, (0, pad)).reshape(rows, width)
            f.write(b">" + name.encode() + b"\n")
            tail = grid.tobytes()
            if pad:  # drop the padding of the final line, keep its newline
                tail = tail[: -(pad + 1)] + b"\n"
            f.write(tail)


def sample_reads(genome: Genome, n: int, length: int, seed: int = 1,
                 bis_rate: float = 0.75, err_rate: float = 0.01):
    """Bisulfite SE reads from both strands.

    Returns (codes (n, length) uint8, lens (n,) int32, origin (n,) int64).
    """
    rng = np.random.default_rng(seed)
    G = genome.length_of_genome
    starts = rng.integers(0, G - length, n)
    # keep each read within one chromosome
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


def sample_pairs(genome: Genome, n: int, length: int, seed: int = 1,
                 frag_lo: int = 150, frag_hi: int = 500,
                 bis_rate: float = 0.75, err_rate: float = 0.01):
    """Bisulfite read pairs: mate 1 = fragment 5' end (C->T world), mate 2 =
    reverse complement of the 3' end (maps G->A, paired.cpp:642-643).

    Returns (codes1, lens1, codes2, lens2).
    """
    rng = np.random.default_rng(seed)
    G = genome.length_of_genome
    frag_len = rng.integers(frag_lo, frag_hi + 1, n)
    starts = rng.integers(0, G - frag_hi, n)
    chrom = np.searchsorted(genome.start_index, starts, side="right") - 1
    ends = genome.start_index.astype(np.int64)[chrom + 1]
    starts = np.minimum(starts, ends - frag_len)

    # bisulfite-convert the two read windows (same fragment, same strand)
    c1 = genome.seq[starts[:, None] + np.arange(length)].copy()
    s2 = starts + frag_len - length
    c2 = genome.seq[s2[:, None] + np.arange(length)].copy()
    for c in (c1, c2):
        is_c = c == 1
        c[is_c & (rng.random((n, length)) < bis_rate)] = 3
    c2 = (3 - c2)[:, ::-1]  # mate 2 is sequenced from the opposite strand

    for c in (c1, c2):
        err = rng.random((n, length)) < err_rate
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
    lens = np.full(n, length, dtype=np.int32)
    return c1, lens, np.ascontiguousarray(c2), lens.copy()


def codes_to_fastq(codes: np.ndarray, lens: np.ndarray, path: str,
                   name_prefix: str = "r") -> None:
    from walt_tpu_torch.constants import CODE_TO_BASE

    n, L = codes.shape
    if n and int(lens.min()) == int(lens.max()):
        # uniform length: decode whole chunks at once and join bytes rows
        # (a per-read decode loop costs minutes at bench scale)
        qual = b"\n+\n" + b"I" * L + b"\n"
        with open(path, "wb") as f:
            for a in range(0, n, 262_144):
                z = min(a + 262_144, n)
                rows = CODE_TO_BASE[codes[a:z]].tobytes()
                f.write(b"".join(
                    b"@%s%d\n" % (name_prefix.encode(), a + j)
                    + rows[j * L : (j + 1) * L] + qual
                    for j in range(z - a)
                ))
        return
    from walt_tpu_torch.genome import decode_to_bytes

    with open(path, "w") as f:
        for i in range(codes.shape[0]):
            s = decode_to_bytes(codes[i, : int(lens[i])]).decode()
            f.write(f"@{name_prefix}{i}\n{s}\n+\n{'I' * int(lens[i])}\n")


def build_synthetic_table(n_bases: int = 200_000, pattern: SeedPattern | None = None,
                          seed: int = 0):
    """(genome, converted CT00 genome, HashTable, DeviceTable) for benches."""
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.ops.device_index import build_device_table

    pattern = pattern or get_pattern("3")
    genome = make_genome(n_bases, seed=seed)
    conv_genome, table = build_table(genome, "CT00", pattern, verbose=False)
    dt = build_device_table(conv_genome, table, pattern, with_key_words=True)
    return genome, conv_genome, table, dt
