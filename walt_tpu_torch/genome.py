"""Genome container and FASTA reading.

Mirrors the observable behavior of the reference's ``Genome`` struct and
``ReadGenome`` (``src/walt/reference.hpp:44-70``, ``reference.cpp:79-129``):
chromosome sequences are concatenated into one array; names are the FASTA
header truncated at the first space/tab; every base is upper-cased and
non-ACGT bases are randomized to A/C/G/T.

Unlike the reference we store the sequence as 2-bit codes in a uint8 array
(A=0 C=1 G=2 T=3), which preserves all comparison semantics (see
constants.py) and is the on-device layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

import numpy as np

from walt_tpu_torch.constants import BASE_TO_CODE, CODE_COMPLEMENT, CODE_TO_BASE
from walt_tpu_torch.glibc_rand import GlibcRand


@dataclasses.dataclass
class Genome:
    names: list  # chromosome names (first word of FASTA header)
    lengths: np.ndarray  # uint32 (n_chroms,)
    start_index: np.ndarray  # uint32 (n_chroms+1,) concatenated offsets
    seq: np.ndarray  # uint8 codes (length_of_genome,)
    strand: str = "+"

    @property
    def n_chroms(self) -> int:
        return len(self.names)

    @property
    def length_of_genome(self) -> int:
        return int(self.seq.shape[0])

    def chrom_id_of(self, pos) -> np.ndarray:
        """Chromosome id for genome position(s) (reference.cpp:43-60)."""
        return np.searchsorted(self.start_index, pos, side="right") - 1


def read_fasta(path: str):
    """Read a FASTA file -> (names, seqs as raw byte arrays).

    Matches ``read_fasta_file`` (smithlab_os.cpp:367-387): lines are
    concatenated verbatim; the name is everything after '>' (trimmed to the
    first space/tab by the caller, as in reference.cpp:94-95).
    """
    names, seqs = [], []
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.rstrip(b"\n")
            if line.startswith(b">"):
                names.append(line[1:].decode())
                seqs.append([])
            else:
                if not seqs:
                    raise RuntimeError(f"sequence before header in {path}")
                seqs[-1].append(line)
    out = [np.frombuffer(b"".join(parts), dtype=np.uint8) for parts in seqs]
    return names, out


def identify_chromosomes(chrom_path: str) -> list:
    """A FASTA file, or a directory scanned for '*.fa' (reference.cpp:62-77)."""
    if os.path.isdir(chrom_path):
        files = sorted(
            os.path.join(chrom_path, f)
            for f in os.listdir(chrom_path)
            if f.endswith(".fa")
        )
        if not files:
            raise RuntimeError(f"no valid files found in: {chrom_path}")
        return files
    return [chrom_path]


def encode_bases(raw: np.ndarray, rng: GlibcRand) -> np.ndarray:
    """Upper-case + toACGT: non-ACGT bases become rand()%4 (util.hpp:156)."""
    upper = np.where((raw >= 97) & (raw <= 122), raw - 32, raw)
    codes = BASE_TO_CODE[upper]
    bad = np.flatnonzero(codes == 255)
    if bad.size:
        codes = codes.copy()
        codes[bad] = rng.random_bases(bad.size)
    return codes


def load_genome(chrom_files: Sequence[str], rng: GlibcRand | None = None) -> Genome:
    """ReadGenome equivalent (reference.cpp:79-129).

    ``rng`` randomizes non-ACGT bases; the reference seeds this with
    time(NULL) (makedb.cpp:88, irreproducible), we default to seed 0.
    """
    if rng is None:
        rng = GlibcRand(0)
    names, seqs = [], []
    for f in chrom_files:
        ns, ss = read_fasta(f)
        for n, s in zip(ns, ss):
            names.append(n.split(" ")[0].split("\t")[0])
            seqs.append(s)
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.uint32)
    start = np.zeros(len(seqs) + 1, dtype=np.uint32)
    np.cumsum(lengths, out=start[1:])
    seq = np.empty(int(start[-1]), dtype=np.uint8)
    for i, s in enumerate(seqs):
        seq[int(start[i]) : int(start[i + 1])] = encode_bases(s, rng)
    return Genome(names=names, lengths=lengths, start_index=start, seq=seq)


def reverse_complement_genome(g: Genome) -> Genome:
    """Per-chromosome reverse complement (reference.cpp:131-146)."""
    seq = g.seq.copy()
    for i in range(g.n_chroms):
        a, b = int(g.start_index[i]), int(g.start_index[i + 1])
        seq[a:b] = CODE_COMPLEMENT[seq[a:b][::-1]]
    return dataclasses.replace(g, seq=seq, strand="-")


def c2t(codes: np.ndarray) -> np.ndarray:
    """C -> T on codes (reference.cpp:148-154)."""
    return np.where(codes == 1, np.uint8(3), codes)


def g2a(codes: np.ndarray) -> np.ndarray:
    """G -> A on codes (reference.cpp:156-162)."""
    return np.where(codes == 2, np.uint8(0), codes)


def decode_to_bytes(codes: np.ndarray) -> bytes:
    return CODE_TO_BASE[codes].tobytes()
