"""Does a long big-mode stream run to its end?  Path 15 (b)'s device map
(`chip_smoke.py --long`): the GRCh37-shaped assembly at `--scale`
(0.0075) and 262,144 of its reads through `pipeline.run` with
`DeviceSearchEngine(..., big=True)`, the deep tier at its defaults, on the
card.  At that scale the deep tier gathers about 52 reads a 4,096-read
block, so its block of 512 fills more slowly than the streaming driver's
ordered writer holds blocks: a checkout without `search_stream`'s bounded
tier wait stops there for good.

    python -m mapad_tpu_torch.tools.stream_stall [--root DIR ...]
        [--limit 300] [--scale 0.0075]

The workload and its index are made by this checkout under
`.smoke/stream_stall/`.  Each `--root` names a checkout of the repository
whose `mapad_tpu_torch` maps it in a process of its own, in the order
given (default: this checkout), stopped after `--limit` seconds.  Prints
the engine's blocks and deep reads every 20 s, and one JSON line a root:
`ended` (true, or false where the limit stopped it), its seconds, blocks
and deep reads.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_READS = 262_144
SEED = 37  # chip_smoke.py's ASSEMBLY_SEED
MAP_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t",
             "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001"]

# runs in a process of its own with the checkout's root first on sys.path
BODY = r"""
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
from mapad_tpu_torch import cli
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.map import pipeline
from mapad_tpu_torch.ops.engine import DeviceSearchEngine

fasta, fastq, out = sys.argv[2:5]
args = cli.build_parser().parse_args(
    ["map", "-r", fastq, "-g", fasta, "-o", out, *sys.argv[5:]])
params = cli.build_alignment_parameters(args)
index = load_index(fasta)
engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes, big=True,
                            packed_hits=True)
t0 = time.perf_counter()
done = threading.Event()


def counts():
    st = engine._stats
    return dict(blocks=st.get("batches", 0),
                deep_retried=st.get("deep_retried", 0))


def progress():
    while not done.wait(20):
        print(json.dumps(dict(seconds=time.perf_counter() - t0, **counts())),
              flush=True)


threading.Thread(target=progress, daemon=True).start()
pipeline.run(fastq, fasta, out, True, params, None, engine=engine,
             position_seed=args.seed, cmdline="mapad map",
             threads=os.cpu_count() or 1, index=index)
done.set()
print(json.dumps(dict(ended=True, seconds=time.perf_counter() - t0,
                      **counts())), flush=True)
os._exit(0)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--limit", type=float, default=300.0)
    ap.add_argument("--scale", type=float, default=0.0075)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from mapad_tpu_torch import cli
    from mapad_tpu_torch.tools import assembly

    work = os.path.join(ROOT, ".smoke", "stream_stall")
    _lay, _b, _r, _k, fasta, fastq = assembly.make(work, a.scale, SEED,
                                                   N_READS)
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    for root in a.root or [ROOT]:
        root = os.path.abspath(root)
        out = os.path.join(work, "device.bam")
        last = {}
        proc = subprocess.Popen(
            [sys.executable, "-c", BODY, root, fasta, fastq, out,
             *MAP_FLAGS], stdout=subprocess.PIPE, text=True)
        try:
            proc.wait(timeout=a.limit)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        for line in proc.stdout:
            if line.startswith("{"):
                last = json.loads(line)
                print(f"  {root}: {line.strip()}", flush=True)
        print(json.dumps(dict(root=root, ended=bool(last.get("ended")),
                              limit_s=a.limit, rc=proc.returncode,
                              **{k: last.get(k) for k in (
                                  "seconds", "blocks", "deep_retried")})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
