"""mapAD-compatible command line interface of the PyTorch + CUDA port.

Counterpart of mapad_tpu/cli.py (reference src/main.rs): the same flag
names and defaults (main.rs:30-303), plus --engine and --lanes.  `index`
and `map` run with every engine of the reference: `--engine hybrid` (the
default: the pool search on one GPU for the head of every block, the exact
host C++ search for its tail), `device` (the pool search alone), `native`
(the host C++ search alone) and `oracle` (the sequential Python search).
`index --mapad_format` also writes mapAD's own index files; `map
--dispatcher` and `worker` are the distributed mode, whose workers run the
pool search on the card (`worker --device cpu` runs the plain versions).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from .errors import MapadError
from .map import AlignmentParameters

logger = logging.getLogger(__name__)


def _prob(value: str) -> float:
    v = float(value)
    if not 0.0 <= v <= 1.0:
        raise argparse.ArgumentTypeError(f"{value} is not in [0, 1]")
    return v


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mapad_tpu_torch",
        description="An aDNA aware short-read mapper (PyTorch + CUDA port)",
    )
    from . import build_info_version

    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {build_info_version()}")
    parser.add_argument("-v", action="count", default=0,
                        help="Sets the level of verbosity")
    parser.add_argument("--threads", type=int, default=1, dest="num_threads",
                        help="Maximum number of host threads (0 = auto)")
    parser.add_argument("--port", type=int, default=3130,
                        help="TCP port to communicate over")
    parser.add_argument("--seed", type=int, default=1234,
                        help="Seed for the random number generator")
    sub = parser.add_subparsers(dest="command", required=True)

    p_index = sub.add_parser("index", help="Indexes a genome file")
    p_index.add_argument(
        "--mapad_format", action="store_true",
        help="Additionally write the reference implementation's index "
             "container (.tbw/.tle/.tsa/.tpi/.tos/.trt; the rust-bio-"
             "internal .toc is re-derived at load time)",
    )
    p_index.add_argument("-g", "--reference", required=True,
                         help="FASTA file containing the genome to be indexed")

    p_map = sub.add_parser("map", help="Maps reads to an indexed genome")
    p_map.add_argument("-r", "--reads", required=True,
                       help='BAM/FASTQ/FASTQ.GZ input; "-" for stdin')
    p_map.add_argument("-g", "--reference", required=True,
                       help="Prefix of the index file names")
    p_map.add_argument("-o", "--output", required=True, help="Path to output BAM file")
    p_map.add_argument("-p", dest="poisson_prob", type=_prob, default=None,
                       help="Minimum probability of the number of mismatches "
                            "under `-D` base error rate")
    p_map.add_argument("-c", dest="as_cutoff", type=float, default=None,
                       help="Per-base average alignment score cutoff")
    p_map.add_argument("-e", dest="as_cutoff_exponent", type=float, default=1.0,
                       help="Exponent applied to the read length")
    p_map.add_argument("-l", "--library", required=True,
                       choices=["single_stranded", "double_stranded"],
                       help="Library preparation method")
    p_map.add_argument("-f", dest="five_prime_overhang", type=_prob, required=True,
                       help="5'-overhang length parameter")
    p_map.add_argument("-t", dest="three_prime_overhang", type=_prob, default=None,
                       help="3'-overhang length parameter (single-stranded only)")
    p_map.add_argument("-d", dest="ds_deamination_rate", type=_prob, required=True,
                       help="Deamination rate in double-stranded stem of a read")
    p_map.add_argument("-s", dest="ss_deamination_rate", type=_prob, required=True,
                       help="Deamination rate in single-stranded ends of a read")
    p_map.add_argument("-D", dest="divergence", type=_prob, default=0.02,
                       help="Divergence / base error rate")
    p_map.add_argument("-i", dest="indel_rate", type=_prob, required=True,
                       help="Expected rate of indels between reads and reference")
    p_map.add_argument("-x", dest="gap_extension_penalty", type=_prob, default=1.0,
                       help="Gap extension penalty as a fraction of the "
                            "representative mismatch penalty")
    p_map.add_argument("--batch_size", dest="chunk_size", type=int, default=250000,
                       help="The number of reads that are processed in parallel")
    p_map.add_argument("--ignore_base_quality", action="store_true",
                       help="Ignore base qualities in scoring models")
    p_map.add_argument("--dispatcher", action="store_true",
                       help="Run in dispatcher mode for distributed computing")
    p_map.add_argument("--gap_dist_ends", type=int, default=5,
                       help="Disallow gaps at read ends (configurable range)")
    p_map.add_argument("--max_num_gaps_open", type=int, default=2,
                       help="Max. number of opened gaps")
    p_map.add_argument("--no_search_limit_recovery", action="store_true",
                       help="Report search-space-limit reads as unmapped")
    p_map.add_argument("--force_overwrite", action="store_true",
                       help="Overwrite the output BAM file if it already exists")
    p_map.add_argument("-R", "--read_group", default=None,
                       help="Read group SAM header line "
                            "(e.g. '@RG\\tID:identifier1\\tSM:sample2')")
    p_map.add_argument("--engine",
                       choices=["hybrid", "device", "native", "oracle"],
                       default="hybrid",
                       help="Search engine: GPU + host cores concurrently "
                            "(hybrid, default), the pool search on the GPU "
                            "only (device), multi-core host C++ (native), "
                            "or sequential Python (oracle)")
    p_map.add_argument("--lanes", type=int, default=2048,
                       help="Device batch width (reads per device step)")
    p_map.add_argument("--device", default="cuda",
                       help="torch device of the hybrid and device engines: "
                            "cuda (every visible card, sharded, where "
                            "there are several), cuda:N (that card "
                            "alone), or cpu to run the plain PyTorch "
                            "versions of the kernels")
    p_map.add_argument("--profile", metavar="DIR", default=None,
                       help="Write a torch.profiler trace of the mapping "
                            "run to DIR (Chrome trace format)")

    p_worker = sub.add_parser("worker", help="Spawns worker")
    p_worker.add_argument("--host", required=True,
                          help="Hostname or IP address of the dispatcher node")
    p_worker.add_argument("--device", default="cuda",
                          help="torch device of the worker's engine: "
                               "cuda (every visible card, sharded, where "
                               "there are several), cuda:N (that card "
                               "alone: a worker per card), or cpu to run "
                               "the plain PyTorch versions of the kernels")
    p_worker.add_argument("--lanes", type=int, default=2048,
                          help="Device batch width (reads per device step)")

    return parser


def parse_read_group(value: str):
    """Parse an '@RG\\tID:x\\t...' header line -> (id, [(key, val)])."""
    value = value.replace("\\t", "\t")
    parts = value.split("\t")
    if parts[0] != "@RG":
        raise ValueError("Read group line must start with @RG")
    rg_id = None
    fields = []
    for p in parts[1:]:
        k, _, v = p.partition(":")
        if k == "ID":
            rg_id = v
        else:
            fields.append((k, v))
    if rg_id is None:
        raise ValueError("Read group line must contain an ID field")
    return rg_id, fields


def build_alignment_parameters(args) -> AlignmentParameters:
    """Port of main.rs:418-499 (penalties are log2 of rates)."""
    from .models import Continuous, Discrete, SimpleAncientDnaModel

    if args.library == "single_stranded":
        if args.three_prime_overhang is None:
            raise SystemExit("-t is required for single-stranded libraries")
        library_prep = (
            "single_stranded", args.five_prime_overhang, args.three_prime_overhang
        )
    else:
        library_prep = ("double_stranded", args.five_prime_overhang)

    divergence = np.float32(args.divergence)
    difference_model = SimpleAncientDnaModel(
        library_prep,
        args.ds_deamination_rate,
        args.ss_deamination_rate,
        # tested against each of the three possible substitutions
        divergence / np.float32(3.0),
        args.ignore_base_quality,
    )
    repr_mm = difference_model.get_representative_mismatch_penalty()

    if args.poisson_prob is not None:
        mismatch_bound = Discrete(args.poisson_prob, divergence, repr_mm)
    elif args.as_cutoff is not None:
        mismatch_bound = Continuous(
            -np.float32(args.as_cutoff), args.as_cutoff_exponent, repr_mm
        )
    else:
        raise SystemExit("either -p or -c must be given")

    return AlignmentParameters(
        difference_model=difference_model,
        mismatch_bound=mismatch_bound,
        penalty_gap_open=np.float32(np.log2(np.float32(args.indel_rate))),
        penalty_gap_extend=np.float32(args.gap_extension_penalty) * repr_mm,
        chunk_size=args.chunk_size,
        gap_dist_ends=args.gap_dist_ends,
        max_num_gaps_open=args.max_num_gaps_open,
        stack_limit_abort=args.no_search_limit_recovery,
    )


TRACE = 5  # reference maps `-vv` to Trace (main.rs:307-309)
logging.addLevelName(TRACE, "TRACE")


def main(argv=None):
    args = build_parser().parse_args(argv)
    level = [logging.INFO, logging.DEBUG, TRACE][min(args.v, 2)]
    logging.basicConfig(
        level=level, format="%(asctime)s %(levelname)s [%(name)s] %(message)s"
    )
    try:
        return _dispatch(args)
    except MapadError as e:
        logger.error("%s", e)
        return 1


def _dispatch(args):

    if args.command == "index":
        from .index.builder import run as index_run

        index_run(
            args.reference, seed=args.seed,
            mapad_format=getattr(args, "mapad_format", False),
        )
        return 0

    if args.command == "map":
        params = build_alignment_parameters(args)
        read_group = parse_read_group(args.read_group) if args.read_group else None
        cmdline = " ".join(sys.argv)

        if args.dispatcher:
            from .distributed.dispatcher import Dispatcher

            dispatcher = Dispatcher(
                args.reads, args.reference, args.output, args.force_overwrite,
                params, read_group, cmdline=cmdline,
            )
            dispatcher.run(args.port)
            return 0

        from .index import load_index
        from .map import native_post

        # engines emit packed (flat-array) hits for the native C++
        # postprocessor
        packed = native_post.available() and not os.environ.get(
            "MAPAD_NO_NATIVE_POST"
        )
        threads = args.num_threads if args.num_threads > 0 else None
        index = load_index(args.reference)
        engine = None  # oracle: `run` makes the sequential Python engine
        if args.engine == "native":
            from .map.native_search import NativeSearchEngine

            engine = NativeSearchEngine(
                index.fmd, params, threads=threads, packed_hits=packed,
            )
        elif args.engine == "hybrid":
            from .ops.engine import HybridSearchEngine

            engine = HybridSearchEngine(
                index.fmd, params, lanes=args.lanes, threads=threads,
                packed_hits=packed, device=args.device,
            )
        elif args.engine == "device":
            from .ops.engine import DeviceSearchEngine

            engine = DeviceSearchEngine(
                index.fmd, params, lanes=args.lanes, packed_hits=packed,
                threads=threads, device=args.device,
            )

        from .map.pipeline import run as mapping_run

        profiling = getattr(args, "profile", None)
        prof = None
        if profiling:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            mapping_run(
                args.reads, args.reference, args.output,
                args.force_overwrite, params, read_group, engine=engine,
                position_seed=args.seed, cmdline=cmdline,
                threads=args.num_threads if args.num_threads > 0
                else (os.cpu_count() or 1),
                index=index,
            )
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(profiling, exist_ok=True)
                path = os.path.join(profiling, "trace.json")
                prof.export_chrome_trace(path)
                logger.info("Profiler trace written to %s", path)
        return 0

    if args.command == "worker":
        from .distributed.worker import Worker

        Worker(args.host, args.port, device=args.device,
               lanes=args.lanes).run()
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
