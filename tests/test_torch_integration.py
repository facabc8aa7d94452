"""The port end to end on the integration fixture of
tests/test_integration.py: `index` then `map` through the streaming block
driver pass the reference goldens, and the BAM equals the JAX package's
record for record (XD, a timing, and the @PG command line excepted), with
the default (hybrid) engine, with store generations and with the narrow
deep config.  A bundle built by either package is the other's, file for
file."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the plain kernels run thousands of tiny tensor ops; one intra-op thread
# per test worker keeps them from spinning against the other workers
torch.set_num_threads(1)

from mapad_tpu.cli import main as j_main  # noqa: E402
from mapad_tpu.io.bam import BamReader  # noqa: E402
from mapad_tpu.map.pipeline import run as j_run  # noqa: E402
from mapad_tpu_torch.cli import main as t_main  # noqa: E402
from mapad_tpu_torch.index.builder import run as t_index_run  # noqa: E402
from mapad_tpu_torch.index.runtime import load_index  # noqa: E402
from mapad_tpu_torch.map.pipeline import run as t_run  # noqa: E402
from mapad_tpu_torch.models import Discrete, SimpleAncientDnaModel  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig  # noqa: E402
from test_integration import _check_results, prepare  # noqa: E402
from torch_port_helpers import unsharded_env  # noqa: E402,F401


def _port_params(jparams):
    """The fixture's AlignmentParameters rebuilt from the port's own
    classes (same constructor arguments as test_integration.prepare)."""
    from mapad_tpu_torch.map import AlignmentParameters

    model = SimpleAncientDnaModel(
        ("single_stranded", 0.6, 0.55), 0.01, 1.0,
        np.float32(0.02) / np.float32(3.0), False,
    )
    repr_mm = model.get_representative_mismatch_penalty()
    p = AlignmentParameters(
        difference_model=model,
        mismatch_bound=Discrete(0.03, 0.02, repr_mm),
        penalty_gap_open=repr_mm * np.float32(1.5),
        penalty_gap_extend=repr_mm * np.float32(0.5),
        chunk_size=jparams.chunk_size, gap_dist_ends=5,
        stack_limit_abort=False, max_num_gaps_open=2,
    )
    assert p.penalty_gap_open == jparams.penalty_gap_open
    return p


def _records(path):
    """Every BAM record's fields and tags, XD dropped."""
    with open(path, "rb") as f:
        reader = BamReader(f)
        header = reader.header_text
        recs = [
            (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
             r.sequence, r.quals,
             [(bytes(t), tc, v) for t, tc, v in r.tags if bytes(t) != b"XD"])
            for r in reader
        ]
    return header, recs


def _header_without_cl(text):
    return [
        "\t".join(f for f in line.split("\t") if not f.startswith("CL:"))
        if line.startswith("@PG\tID:mapAD") else line
        for line in text.splitlines()
    ]


def test_port_streaming_map_passes_goldens(tmp_path):
    genome, input_bam, jparams = prepare(tmp_path)
    # the port indexes the genome again: the bundle it writes must be the
    # JAX package's, file for file
    bundle = str(genome) + ".tpx"
    jfiles = {n: open(os.path.join(bundle, n), "rb").read()
              for n in os.listdir(bundle)}
    t_index_run(str(genome), seed=1234)
    assert sorted(os.listdir(bundle)) == sorted(jfiles)
    for name, data in jfiles.items():
        assert open(os.path.join(bundle, name), "rb").read() == data, name

    params = _port_params(jparams)
    index = load_index(str(genome))
    cfg = PoolConfig(max_len=64, lanes=8, total_steps=8192, max_chains=256)
    engine = DeviceSearchEngine(index.fmd, params, pool_config=cfg,
                                packed_hits=True, device="cpu")
    engine.block_reads = 8  # several streamed blocks
    out = tmp_path / "port.bam"
    t_run(str(input_bam), str(genome), str(out), False, params, None,
          engine=engine, cmdline="mapad map", index=index)
    _check_results(out)

    ref_out = tmp_path / "jax.bam"
    j_run(str(input_bam), str(genome), str(ref_out), False, jparams, None,
          cmdline="mapad map")
    got, want = _records(out), _records(ref_out)
    assert got[1] == want[1]
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])


def test_port_big_mode_streaming_map_equals_jax(tmp_path, monkeypatch):
    """big=True through `pipeline.run` with big mode's defaults (Bi-D on
    the device, deep tier on, int64 intervals through the native BAM
    conversion): the goldens pass and the BAM equals the JAX package's
    big-mode BAM record for record."""
    from mapad_tpu.index.runtime import load_index as j_load_index
    from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine
    from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig

    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_RETRY_TIER"):
        monkeypatch.delenv(name, raising=False)
    genome, input_bam, jparams = prepare(tmp_path)
    params = _port_params(jparams)
    # a per-read cap of 48: some reads abandon and take the deep tier
    shape = dict(max_len=64, lanes=8, total_steps=8192, read_step_cap=48,
                 max_chains=256)
    index = load_index(str(genome))
    engine = DeviceSearchEngine(index.fmd, params, big=True,
                                pool_config=PoolConfig(**shape),
                                packed_hits=True, device="cpu")
    assert engine.device_index.big and engine.deep_tier_enabled()
    engine.block_reads = 8
    out = tmp_path / "port_big.bam"
    t_run(str(input_bam), str(genome), str(out), False, params, None,
          engine=engine, cmdline="mapad map", index=index)
    _check_results(out)

    jindex = j_load_index(str(genome))
    jengine = JEngine(jindex.fmd, jparams, mode="pool", big=True,
                      pool_config=JPoolConfig(compute_forward_part=False,
                                              **shape),
                      packed_hits=True)
    jengine.block_reads = 8
    ref_out = tmp_path / "jax_big.bam"
    j_run(str(input_bam), str(genome), str(ref_out), False, jparams, None,
          engine=jengine, cmdline="mapad map", index=jindex)
    got, want = _records(out), _records(ref_out)
    assert got[1] == want[1]
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])
    for name in ("escalated", "oracle", "deep_retried", "nohit_host"):
        assert engine._stats.get(name, 0) == jengine._stats.get(name, 0), name
    assert engine._stats["esc_why"] == jengine._stats["esc_why"]


def test_port_cli_equals_jax_cli(tmp_path, monkeypatch):
    genome, input_bam, _ = prepare(tmp_path)
    flags = ["-r", str(input_bam), "-g", str(genome), "-p", "0.03", "-l",
             "single_stranded", "-f", "0.6", "-t", "0.55", "-d", "0.01",
             "-s", "1.0", "-i", "0.001", "--batch_size", "7"]
    # a narrow pool so the plain PyTorch kernels run quickly on the CPU
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    monkeypatch.setenv("MAPAD_BLOCK_READS", "8")
    assert t_main(["index", "-g", str(genome)]) == 0
    t_out = tmp_path / "port_cli.bam"
    trace_dir = tmp_path / "trace"
    assert t_main(["map", *flags, "-o", str(t_out), "--lanes", "8",
                   "--device", "cpu", "--profile", str(trace_dir)]) == 0
    assert (trace_dir / "trace.json").stat().st_size > 0
    j_out = tmp_path / "jax_cli.bam"
    assert j_main(["map", *flags, "-o", str(j_out), "--engine",
                   "native"]) == 0
    got, want = _records(t_out), _records(j_out)
    assert len(got[1]) == 17
    assert got[1] == want[1]
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])


def test_port_store_generations_streaming_map_equals_jax(tmp_path,
                                                        monkeypatch):
    """Through `pipeline.run`, the primary config with store generations (a
    step budget too small for a block) and the deep tier narrowed with
    MAPAD_DEEP_LANES (its own generations): the goldens pass, BAM and
    counters equal the JAX package's."""
    from mapad_tpu.index.runtime import load_index as j_load_index
    from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine
    from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig

    for name in ("MAPAD_HOST_BID", "MAPAD_RETRY_TIER", "MAPAD_DEEP_KGENS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_DEEP_TIER", "1")
    monkeypatch.setenv("MAPAD_DEEP_LANES", "4")
    monkeypatch.setenv("MAPAD_DEEP_NOHIT_HOST", "0")
    monkeypatch.setenv("MAPAD_KGENS_MIN_LIVE", "1")
    genome, input_bam, jparams = prepare(tmp_path)
    params = _port_params(jparams)
    shape = dict(max_len=64, lanes=8, total_steps=72, read_step_cap=48,
                 max_chains=256, generations=4, min_live=1)
    index = load_index(str(genome))
    engine = DeviceSearchEngine(index.fmd, params,
                                pool_config=PoolConfig(**shape),
                                packed_hits=True, device="cpu")
    assert engine._deep_config().generations == 4
    engine.block_reads = 17
    out = tmp_path / "port_gens.bam"
    t_run(str(input_bam), str(genome), str(out), False, params, None,
          engine=engine, cmdline="mapad map", index=index)
    _check_results(out)
    assert engine._stats["steps"] > 72  # a boundary fired

    jindex = j_load_index(str(genome))
    jengine = JEngine(jindex.fmd, jparams, mode="pool",
                      pool_config=JPoolConfig(compute_forward_part=False,
                                              **shape),
                      packed_hits=True)
    jengine.block_reads = 17
    ref_out = tmp_path / "jax_gens.bam"
    j_run(str(input_bam), str(genome), str(ref_out), False, jparams, None,
          engine=jengine, cmdline="mapad map", index=jindex)
    got, want = _records(out), _records(ref_out)
    assert got[1] == want[1]
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])
    for name in ("escalated", "oracle", "deep_retried", "nohit_host"):
        assert engine._stats.get(name, 0) == jengine._stats.get(name, 0), name
    assert engine._stats["esc_why"] == jengine._stats["esc_why"]


def test_port_default_engine_is_hybrid(tmp_path, monkeypatch):
    """`map` with no `--engine` makes the hybrid engine, as mapad_tpu's CLI
    does, and `run` with no engine the sequential oracle."""
    from mapad_tpu.cli import build_parser as j_parser
    from mapad_tpu_torch import cli
    from mapad_tpu_torch.ops import engine as teng

    argv = ["map", "-r", "x", "-g", "x", "-o", "x", "-l", "single_stranded",
            "-f", "0.5", "-d", "0.02", "-s", "1.0", "-i", "0.001"]
    ours, theirs = cli.build_parser().parse_args(argv), j_parser().parse_args(
        argv)
    assert ours.engine == theirs.engine == "hybrid"
    assert [a.choices for a in cli.build_parser()._subparsers._group_actions[
        0].choices["map"]._actions if a.dest == "engine"] == [
        ["hybrid", "device", "native", "oracle"]]

    made = []

    class Spy(teng.HybridSearchEngine):
        def __init__(self, *a, **kw):
            made.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(teng, "HybridSearchEngine", Spy)
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    genome, input_bam, _ = prepare(tmp_path)
    assert cli.main(["map", "-r", str(input_bam), "-g", str(genome), "-o",
                     str(tmp_path / "o.bam"), "-p", "0.03", "-l",
                     "single_stranded", "-f", "0.6", "-t", "0.55", "-d",
                     "0.01", "-s", "1.0", "-i", "0.001", "--lanes", "8",
                     "--device", "cpu"]) == 0
    assert len(made) == 1 and made[0]["device"] == "cpu"
    assert len(_records(tmp_path / "o.bam")[1]) == 17


def test_port_cli_index_mapad_format_then_map_on_its_files(tmp_path):
    """`index --mapad_format` writes mapAD's own index files beside the
    bundle, the JAX package's CLI writes the same bytes, and with the
    bundle gone `map` reads those files (the `load_index` fallback) into
    the BAM that the JAX package writes from them and from its bundle."""
    import shutil

    from mapad_tpu_torch.index.mapad_native import MAPAD_SUFFIXES

    genome, input_bam, _ = prepare(tmp_path)
    for tag in ("port", "jax"):
        (tmp_path / tag).mkdir()
        shutil.copy(genome, tmp_path / tag / "g.fa")
    ours, theirs = str(tmp_path / "port" / "g.fa"), str(tmp_path / "jax"
                                                         / "g.fa")
    assert t_main(["index", "--mapad_format", "-g", ours]) == 0
    assert j_main(["index", "--mapad_format", "-g", theirs]) == 0
    for s in (*MAPAD_SUFFIXES, ".toc"):
        with open(ours + s, "rb") as a, open(theirs + s, "rb") as b:
            assert a.read() == b.read(), s
    shutil.rmtree(ours + ".tpx")
    assert load_index(ours).meta["format"] == "mapad-native"

    def native_map(main, ref, out):
        assert main(["map", "-r", str(input_bam), "-g", ref, "-o",
                     str(tmp_path / out), "-p", "0.03", "-l",
                     "single_stranded", "-f", "0.6", "-t", "0.55", "-d",
                     "0.01", "-s", "1.0", "-i", "0.001", "--engine",
                     "native"]) == 0
        return _records(tmp_path / out)

    got = native_map(t_main, ours, "port.bam")
    for want in (native_map(j_main, theirs, "jax.bam"),
                 native_map(j_main, str(genome), "jax_bundle.bam")):
        assert got[1] == want[1]
        assert _header_without_cl(got[0]) == _header_without_cl(want[0])
    assert sum(1 for r in got[1] if not r[1] & 0x4) >= 10


def test_port_cli_dispatcher_with_a_cli_worker(tmp_path, monkeypatch):
    """`--port P map --dispatcher` on a thread and `--port P worker --device
    cpu` (the plain kernels, 8 lanes, 2,048 steps) beside it: the BAM is
    the JAX package's `map` of the same chunks (position seed 0, as the
    dispatcher draws a position for a read of several best hits)."""
    import socket
    import threading
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    genome, input_bam, _ = prepare(tmp_path)
    out = tmp_path / "distributed.bam"
    rcs = []
    argv = ["map", "--batch_size", "6", "-r", str(input_bam), "-g",
            str(genome), "-p", "0.03", "-l", "single_stranded", "-f", "0.6",
            "-t", "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001", "-o"]
    dispatcher = threading.Thread(target=lambda: rcs.append(t_main([
        "--port", port, *argv, str(out), "--dispatcher"])), daemon=True)
    dispatcher.start()
    time.sleep(0.5)
    assert t_main(["--port", port, "worker", "--host", "127.0.0.1",
                   "--device", "cpu", "--lanes", "8"]) == 0
    dispatcher.join(timeout=120)
    assert not dispatcher.is_alive() and rcs == [0]
    local = tmp_path / "local.bam"
    assert j_main(["--seed", "0", *argv, str(local), "--engine",
                   "native"]) == 0
    got, want = _records(out), _records(local)
    assert sorted(got[1]) == sorted(want[1])
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_port_cli_worker_on_the_card_raises_without_cuda(monkeypatch,
                                                        device):
    """`worker` runs on the card unless `--device cpu` is given: without
    CUDA it raises before it connects, with no fallback to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--port", "1", "worker", "--host", "127.0.0.1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(argv + (["--device", device] if device else []))
