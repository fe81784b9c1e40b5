"""Command-line mapper of the port: ``python -m walt_tpu_torch.cli``.

The flag surface is WALT's (flags and validation, walt.cpp:130-246, as the
JAX package's CLI has them), with ``--backend {torch,numpy}`` and
``--device {cuda,cpu}``.  Single-end files (``-r``) go through
``walt_tpu_torch.core.single_end.process_single_end``, then paired-end
files (``-1``/``-2``) through
``walt_tpu_torch.core.paired_end.process_paired_end``, all on one backend.

With ``--device cuda`` the backend spans every visible card as a (dp, tp)
mesh, the table split ``--tp`` ways (one card maps unsharded, and ``--tp``
then has no effect); ``--device cpu`` is one device.  ``--multihost`` runs
one process per host over ``torch.distributed`` (``parallel/multihost``):
read files are dealt round-robin and every output is byte-identical to a
single-host run.  ``index`` builds an index and ``merge-stats`` sums
``.mapstats`` files of split inputs.  ``WALTX_PROFILE_DIR=<dir>`` writes a
torch.profiler trace of each run's mapping loop into <dir>
(``perf.profiler_trace``).
"""

from __future__ import annotations

import argparse
import os
import sys

MAX_BATCH = 100_000_000  # walt.cpp:119
FASTQ_SUFFIXES = (".fastq", ".fq")  # walt.cpp:92


def _split_filenames(csv: str):
    """Comma- or space-separated list (walt.cpp:47-55)."""
    return [s for s in csv.replace(",", " ").split() if s]


#: options that take no value (for config-file boolean lines)
_FLAG_NAMES = frozenset(
    ("a", "ambiguous", "u", "unmapped", "A", "ag-wild", "P", "pbat", "sam",
     "v", "verbose")
)


def _apply_config_file(argv):
    """``-config-file FILE`` support (OptionParser.cpp:279-344).

    The file holds ``name=value`` lines ('#' comments skipped); names are
    option names without dashes.  Command-line arguments override the file
    (the reference parses the config first, then lets argv overwrite).
    """
    argv = list(argv)
    for i, a in enumerate(argv):
        if a in ("-config-file", "--config-file"):
            if i + 1 >= len(argv):
                raise SystemExit("-config-file requires config filename")
            path = argv[i + 1]
            try:
                lines = open(path).read().splitlines()
            except OSError:
                raise SystemExit(f"cannot open config file: {path}")
            injected = []
            for ln, line in enumerate(lines, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    raise SystemExit(
                        f"Line {ln} malformed in config file {path}"
                    )
                name, _, val = line.partition("=")
                name, val = name.strip(), val.strip()
                if name in _FLAG_NAMES:
                    if val.lower() in ("true", "1", "yes", "on"):
                        injected.append(f"-{name}")
                else:
                    injected += [f"-{name}", val]
            # injected first: later (command-line) occurrences win
            return injected + argv[:i] + argv[i + 2:]
    return argv


def _validate_index(index: str) -> None:
    """walt.cpp:67-85."""
    if not os.path.isfile(index):
        raise SystemExit(f"bad index file: {index}")
    for suf in ("_CT00", "_CT01", "_GA10", "_GA11"):
        if not os.path.isfile(index + suf):
            raise SystemExit(f"bad table file: {index + suf}")


def build_map_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waltx", description="map Illumina BS-seq reads (TPU-native WALT)"
    )
    a = p.add_argument
    a("-i", "-index", "--index", dest="index", required=True,
      help="index file created by 'waltx index' or WALT makedb (.dbindex)")
    a("-r", "-reads", "--reads", dest="reads", default="",
      help="comma-sep list of single-end read files (.fastq/.fq)")
    a("-1", "-reads1", "--reads1", dest="reads1", default="",
      help="comma-sep list of mate-1 read files")
    a("-2", "-reads2", "--reads2", dest="reads2", default="",
      help="comma-sep list of mate-2 read files")
    a("-o", "-output", "--output", dest="output", required=True,
      help="output file names (comma sep)")
    a("-m", "-mismatch", "--mismatch", dest="mismatch", type=int, default=6,
      help="max allowed mismatches")
    a("-N", "-number", "--number", dest="batch", type=int, default=10_000_000,
      help="number of reads per batch")
    a("-a", "-ambiguous", "--ambiguous", dest="ambiguous", action="store_true",
      help="output one random location for ambiguously mapped reads")
    a("-u", "-unmapped", "--unmapped", dest="unmapped", action="store_true",
      help="output unmapped reads in separate file")
    a("-C", "-clip", "--clip", dest="adaptor", default="",
      help="clip the specified adaptor")
    a("-A", "-ag-wild", "--ag-wild", dest="ag_wildcard", action="store_true",
      help="map using A/G bisulfite wildcards (single-end)")
    a("-P", "-pbat", "--pbat", dest="pbat", action="store_true",
      help="reads are PBAT (post-bisulfite adaptor tagging): mate "
           "conversion roles swap (README.md:100-104 extension; the "
           "reference documents but does not implement -P)")
    a("-b", "-bucket", "--bucket", dest="bucket", type=int, default=5000,
      help="maximum candidates for a seed")
    a("-k", "-topk", "--topk", dest="top_k", type=int, default=50,
      help="maximum allowed mappings for a read (paired-end)")
    a("-L", "-fraglen", "--fraglen", dest="fraglen", type=int, default=1000,
      help="max fragment length (paired-end)")
    a("-sam", "--sam", dest="sam", action="store_true", help="output SAM format")
    a("-v", "-verbose", "--verbose", dest="verbose", action="store_true")
    a("-t", "-thread", "--thread", dest="threads", type=int, default=1,
      help="host-side worker threads for the exact fallback/oracle paths "
           "(device parallelism is the mesh; walt.cpp:165-166 analog)")
    # extensions (--backend and --device: build_parser)
    a("--tp", dest="tp", type=int, default=1,
      help="table-parallel ways: shard the CSR hash table by bucket-key "
           "range over tp devices (for indexes larger than one chip's HBM); "
           "remaining devices map reads data-parallel")
    a("--seed-pattern", default="3", choices=("3", "5", "7"),
      help="spaced seed pattern (reference compile-time -D SEEDPATTERN*)")
    a("--resume", dest="resume", action="store_true",
      help="checkpoint after every batch and continue an interrupted run "
           "from its last completed batch (walt_tpu_torch.host.resume)")
    a("--multihost", dest="multihost", action="store_true",
      help="multi-host run (torch.distributed): read files are "
           "data-parallel round-robin across processes; outputs must be "
           "1:1 with inputs so every file's output is byte-identical to a "
           "single-host run (walt_tpu_torch.parallel.multihost)")
    return p


def _about_or_help(argv, parser, prog: str, descr: str) -> bool:
    """OptionParser's ``-about`` / ``-?`` surface (OptionParser.cpp:382-386).

    ``-about`` prints the "PROGRAM: <name>" banner plus the program
    description (about_message, OptionParser.cpp:433-452); ``-?`` is a help
    alias (argparse already covers -h/--help).
    """
    if any(a in ("-about", "--about") for a in argv):
        print(f"PROGRAM: {prog}")
        print(descr)
        return True
    if "-?" in argv:
        parser.print_help()
        return True
    return False


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m walt_tpu_torch.cli",
        description="map Illumina BS-seq reads (WALT-compatible, "
                    "PyTorch/CUDA)",
        parents=[build_map_parser()], add_help=False,
    )
    p.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                   help="candidate enumeration backend (torch=device "
                        "pipeline, numpy=host oracle)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device of the torch backend")
    return p


def main_index(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="waltx index", description="build index for reference genome"
    )
    p.add_argument("-c", "-chrom", "--chrom", dest="chrom", required=True,
                   help="chromosomes in FASTA file or dir ('.fa')")
    p.add_argument("-o", "-output", "--output", dest="output", required=True,
                   help="output file name (suffix '.dbindex')")
    p.add_argument("--seed-pattern", default="3", choices=("3", "5", "7"))
    p.add_argument("--rand-seed", type=int, default=0,
                   help="seed for non-ACGT randomization (reference uses "
                        "time(NULL), which is irreproducible)")
    # description mirrors makedb.cpp:93 for `-about` parity
    if _about_or_help(argv or [], p, "waltx index",
                      "build index for reference genome"):
        return 0
    args = p.parse_args(argv)
    if not args.output.endswith(".dbindex"):
        raise SystemExit("The suffix of the output file should be '.dbindex'")

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.genome import identify_chromosomes
    from walt_tpu_torch.hostmem import prefault
    from walt_tpu_torch.index.build import build_all_tables
    from walt_tpu_torch.index.io_walt import write_index

    prefault()
    files = identify_chromosomes(args.chrom)
    genome, tables = build_all_tables(
        files, get_pattern(args.seed_pattern), seed=args.rand_seed
    )
    write_index(args.output, genome, tables)
    return 0


def main_merge_stats(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m walt_tpu_torch.cli merge-stats",
        description="sum .mapstats files from split-input runs into one",
    )
    p.add_argument("stats", nargs="+", help="per-part .mapstats files")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    from walt_tpu_torch.parallel.multihost import merge_mapstats

    merge_mapstats(args.stats, args.output)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "index":
        return main_index(argv[1:])
    if argv and argv[0] == "merge-stats":
        return main_merge_stats(argv[1:])
    return main_map(argv)


def main_map(argv) -> int:
    argv = _apply_config_file(argv)
    if argv and argv[0] == "map":
        argv = argv[1:]
    parser = build_parser()
    if _about_or_help(argv, parser, "waltx", "map Illumina BS-seq reads"):
        return 0
    args = parser.parse_args(argv)
    _validate_index(args.index)

    se_files = _split_filenames(args.reads)
    pe1 = _split_filenames(args.reads1)
    pe2 = _split_filenames(args.reads2)
    if len(pe1) != len(pe2):
        raise SystemExit("unequal number of end1 and end2 files")
    for f in se_files + pe1 + pe2:
        if not f.endswith(FASTQ_SUFFIXES):
            raise SystemExit(f"read file invalid suffix: {f}")
    outputs = _split_filenames(args.output)
    n_runs = len(se_files) + len(pe1)
    if len(outputs) != 1 and len(outputs) != n_runs:
        raise SystemExit(f"wrong number of output files: {args.output}")
    if len(outputs) == 1:
        outputs = outputs * n_runs
    if args.batch > MAX_BATCH:
        raise SystemExit(f"batch size may not exceed {MAX_BATCH}")
    if not (2 <= args.top_k <= 300):
        raise SystemExit("paired-end candidates must be in [2, 300]")

    # multi-host: file-granular data parallelism across processes; each
    # run's outputs are byte-identical to a single-host run of that file
    pid, nproc = 0, 1
    if args.multihost:
        from walt_tpu_torch.parallel import multihost

        if len(set(outputs)) != n_runs:
            raise SystemExit("--multihost needs one output file per input "
                             "file")
        pid, nproc = multihost.initialize()

    from walt_tpu_torch.core.backends import get_backend

    if args.backend == "torch":
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        backend = get_backend(
            "torch", device=args.device,
            mesh="auto" if args.device == "cuda" else None, tp=args.tp)
    else:
        backend = get_backend("numpy")

    # clear output files so later appends make sense (walt.cpp:229-233);
    # under --resume process_single_end / process_paired_end restore or
    # truncate from their checkpoints.  Under --multihost each process
    # touches only its own runs' outputs.
    shared_output = len(set(outputs)) != len(outputs)
    if not args.resume:
        for oi, out in enumerate(outputs):
            if oi % nproc != pid:
                continue
            open(out, "w").close()
            open(out + ".mapstats", "w").close()
    elif shared_output:
        import glob

        for out in set(outputs):
            if not glob.glob(glob.escape(out) + ".waltx_ckpt*"):
                open(out, "w").close()
                open(out + ".mapstats", "w").close()
    if args.threads > 1:
        from walt_tpu_torch.host import replay

        replay.set_host_threads(args.threads)

    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    runs = [(f, None) for f in se_files] + list(zip(pe1, pe2))
    for oi, ((f1, f2), out) in enumerate(zip(runs, outputs)):
        if oi % nproc != pid:
            continue
        # per-file reset: file N's phase schedule must not depend on N-1
        if hasattr(backend, "reset_adaptive"):
            backend.reset_adaptive()
        common = dict(
            batch_size=args.batch, max_mismatches=args.mismatch,
            b=args.bucket, adaptor=args.adaptor, ambiguous=args.ambiguous,
            unmapped=args.unmapped, sam=args.sam, backend=backend,
            pattern_name=args.seed_pattern, verbose=args.verbose,
            resume=args.resume,
            ckpt_tag=f".run{oi}" if (args.resume and shared_output) else "",
        )
        if f2 is None:
            process_single_end(args.index, f1, out,
                               ag_wildcard=args.ag_wildcard or args.pbat,
                               **common)
        else:
            process_paired_end(args.index, f1, f2, out, top_k=args.top_k,
                               frag_range=args.fraglen, pbat=args.pbat,
                               **common)
    if args.multihost:
        multihost.barrier()
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
