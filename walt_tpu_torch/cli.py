"""Command-line mapper of the port: ``python -m walt_tpu_torch.cli``.

The flag surface is ``walt_tpu.cli``'s (WALT's flags and validation,
walt.cpp:130-246), reused by import, with ``--backend {torch,numpy}`` in
place of ``{jax,numpy}`` and ``--device {cuda,cpu}``.  Single-end files
(``-r``) go through ``walt_tpu.core.single_end.process_single_end``, then
paired-end files (``-1``/``-2``) through
``walt_tpu.core.paired_end.process_paired_end``, all on one backend.

With ``--device cuda`` the backend spans every visible card as a (dp, tp)
mesh, the table split ``--tp`` ways (one card maps unsharded, and ``--tp``
then has no effect); ``--device cpu`` is one device.  ``--multihost`` runs
one process per host over ``torch.distributed`` (``parallel/multihost``):
read files are dealt round-robin and every output is byte-identical to a
single-host run.  ``index`` builds an index (walt_tpu's indexer) and
``merge-stats`` sums ``.mapstats`` files of split inputs.
``WALTX_PROFILE_DIR`` (walt_tpu's JAX profiler hook) is not ported and is
rejected.
"""

from __future__ import annotations

import argparse
import os
import sys

from walt_tpu.cli import (
    FASTQ_SUFFIXES, MAX_BATCH, _about_or_help, _apply_config_file,
    _split_filenames, _validate_index, build_map_parser,
)


def build_parser():
    # "resolve" lets the --backend below replace walt_tpu's
    p = argparse.ArgumentParser(
        prog="python -m walt_tpu_torch.cli",
        description="map Illumina BS-seq reads (WALT-compatible, "
                    "PyTorch/CUDA)",
        parents=[build_map_parser()], conflict_handler="resolve",
        add_help=False,
    )
    p.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                   help="candidate enumeration backend (torch=device "
                        "pipeline, numpy=host oracle)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device of the torch backend")
    return p


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
        from walt_tpu.cli import main_index

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

    if os.environ.get("WALTX_PROFILE_DIR"):
        # the reused process_single_end would start walt_tpu's JAX profiler
        raise SystemExit("WALTX_PROFILE_DIR is walt_tpu's JAX profiler hook; "
                         "unset it for walt_tpu_torch")
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
        from walt_tpu.host import replay

        replay.set_host_threads(args.threads)

    from walt_tpu.core.paired_end import process_paired_end
    from walt_tpu.core.single_end import process_single_end

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
