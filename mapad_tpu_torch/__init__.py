"""mapad_tpu_torch: the PyTorch + CUDA port of mapad_tpu for NVIDIA H100s.

Same layers and module names as mapad_tpu (the JAX reference, which stays
as it is); this package imports torch, numpy and the standard library and
nothing of JAX or of mapad_tpu.  Host layers (io, index, models, map) are
copies; the device search (ops/) runs hand-written CUDA kernels
(csrc/*.cu) with a plain PyTorch version of each beside it.

Layer map:
  cli          -- `mapad-tpu-torch {index,map,worker}` command line
  index        -- index construction (SAIS, BWT, Occ, sampled SA) + loaders
  models       -- sequence difference models + mismatch bounds
  ops          -- device compute: FMD rank queries, pool search with store
                  generations, chain extraction, prep unpack, Bi-D, result
                  pack (CUDA + plain torch); the device and hybrid engines
  parallel     -- the pool search over several devices (K9) and multi-host
                  mapping over torch.distributed
  distributed  -- mapAD's cluster mode: the dispatcher (`map
                  --dispatcher`), the worker (the pool engine on its card)
                  and their wire format
  map          -- mapping pipeline, host C++ search/postprocess bindings,
                  the sequential Python search and BAM conversion
  io           -- FASTA/FASTQ/BAM/BGZF/CRAM readers and writers
  tools        -- the ports of the TPU round's DMA probes (P1-P4) and the
                  kernels' timing tools (python -m mapad_tpu_torch.tools.*)
"""

__version__ = "0.1.0"

CRATE_NAME = "mapAD"
PROG_NAME = "mapad_tpu"


def build_info_version() -> str:
    """Version string with git state, like the reference's `built` embed
    (src/lib.rs:9-27): "<semver> (<short-hash>[-dirty])" when the source
    tree is a git checkout, plain semver otherwise.  Cached per process."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import os
        import subprocess

        ver = __version__
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        try:
            h = subprocess.run(
                ["git", "-C", root, "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
            )
            if h.returncode == 0:
                dirty = subprocess.run(
                    ["git", "-C", root, "status", "--porcelain",
                     "--untracked-files=no"],
                    capture_output=True, text=True, timeout=5,
                )
                suffix = "-dirty" if dirty.stdout.strip() else ""
                ver = f"{ver} ({h.stdout.strip()}{suffix})"
        except Exception:
            pass
        _BUILD_INFO = ver
    return _BUILD_INFO


_BUILD_INFO = None
