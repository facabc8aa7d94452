"""Distributed mode of mapad_tpu_torch against mapad_tpu, on localhost TCP:
a port dispatcher with two port workers (the pool search's plain versions
on the CPU) writes the JAX package's BAM, a dead worker's chunk is queued
again, either package's worker serves the other's dispatcher, the bytes on
the wire are the same in both packages, and a worker with no device named
runs on the card or raises, never on the host oracle."""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.distributed import wire as jwire  # noqa: E402
from mapad_tpu.distributed.dispatcher import Dispatcher as JDispatcher  # noqa: E402
from mapad_tpu.distributed.worker import Worker as JWorker  # noqa: E402
from mapad_tpu.map.pipeline import OracleSearchEngine as JOracle  # noqa: E402
from mapad_tpu_torch.distributed import wire as twire  # noqa: E402
from mapad_tpu_torch.distributed.dispatcher import Dispatcher  # noqa: E402
from mapad_tpu_torch.distributed.worker import Worker  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine  # noqa: E402
from test_integration import _check_results, prepare  # noqa: E402
from test_torch_integration import _port_params  # noqa: E402
from torch_port_helpers import bam_records  # noqa: E402

JOIN_S = 240  # a hang fails the test instead of eating the suite's limit
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve(worker):
    """`worker.run()`, once the dispatcher's thread listens."""
    for _ in range(200):
        try:
            return worker.run()
        except ConnectionRefusedError:
            time.sleep(0.05)
    raise TimeoutError("the dispatcher never listened")


def _run(dispatcher, workers, port):
    """The dispatcher and its workers, each on a thread of its own; joined
    with a timeout.  -> the errors the workers raised."""
    errors = []

    def serve(worker):
        try:
            _serve(worker)
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    d_thread = threading.Thread(target=dispatcher.run, args=(port,),
                                daemon=True)
    d_thread.start()
    threads = [threading.Thread(target=serve, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    d_thread.join(timeout=JOIN_S)
    assert not d_thread.is_alive(), "the dispatcher did not finish"
    assert not any(t.is_alive() for t in threads), "a worker hangs"
    return errors


def _port_worker(port):
    return Worker("127.0.0.1", port, device="cpu", lanes=8)


def _jax_worker(port):
    return JWorker("127.0.0.1", port,
                   engine_factory=lambda fmd, p: JOracle(fmd, p))


def _dispatch(pkg, genome, input_bam, out, params, workers):
    make = Dispatcher if pkg == "port" else JDispatcher
    port = free_port()
    dispatcher = make(str(input_bam), str(genome), str(out), False, params,
                      None, cmdline="mapad map")
    assert not _run(dispatcher, [w(port) for w in workers], port)


CHUNK = 6  # three chunks of the fixture's 17 reads


@pytest.fixture
def fixture(tmp_path, monkeypatch):
    """The integration fixture in chunks of CHUNK reads, with the port's
    pool config cut to CPU size (8 lanes, 2,048 steps, as
    tests/test_torch_integration.py runs it: every chunk costs the plain
    kernels ~8 s on one core)."""
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    genome, input_bam, jparams = prepare(tmp_path)
    jparams = dataclasses.replace(jparams, chunk_size=CHUNK)
    return genome, input_bam, jparams, _port_params(jparams)


def _sorted_records(path):
    """The BAM's records in name order: a dispatcher writes each chunk as
    its result comes in."""
    return sorted(bam_records(path))


@pytest.fixture
def jax_bam(fixture, tmp_path):
    """mapad_tpu's dispatcher with two oracle workers
    (tests/test_integration.py::test_integration_distributed)."""
    genome, input_bam, jparams, _ = fixture
    out = tmp_path / "jax.bam"
    _dispatch("jax", genome, input_bam, out, jparams,
              [_jax_worker, _jax_worker])
    return out


def cli_workers(port, n, device="cpu"):
    """n port workers, each `python -m mapad_tpu_torch.cli --port P worker`
    in a process of its own (threads of one process would take turns at
    the interpreter lock between the plain kernels' many small ops)."""
    env = dict(os.environ, MAPAD_POOL_STEPS="2048", OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, "-m", "mapad_tpu_torch.cli", "--port",
             str(port), "worker", "--host", "127.0.0.1", "--device", device,
             "--lanes", "8"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for _ in range(n)
    ]


def join_workers(procs):
    """Wait for the worker processes (killed at JOIN_S) -> their output."""
    try:
        outs = [p.communicate(timeout=JOIN_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    return outs


def test_port_dispatcher_with_two_port_workers(fixture, jax_bam, tmp_path):
    """The port's dispatcher with two of its CLI workers, each in its own
    process (the plain kernels on the CPU)."""
    genome, input_bam, _, params = fixture
    out = tmp_path / "port.bam"
    port = free_port()
    dispatcher = Dispatcher(str(input_bam), str(genome), str(out), False,
                            params, None, cmdline="mapad map")
    d_thread = threading.Thread(target=dispatcher.run, args=(port,),
                                daemon=True)
    d_thread.start()
    time.sleep(0.2)
    join_workers(cli_workers(port, 2))
    d_thread.join(timeout=JOIN_S)
    assert not d_thread.is_alive()
    _check_results(out)
    assert _sorted_records(out) == _sorted_records(jax_bam)


@pytest.mark.parametrize("dispatcher", ["port", "jax"])
def test_a_worker_of_one_package_serves_the_others_dispatcher(
        fixture, jax_bam, tmp_path, dispatcher):
    """A port worker (plain kernels on the CPU) behind mapad_tpu's
    dispatcher, and mapad_tpu's worker behind the port's: the bytes on the
    wire are the same, and so is the BAM."""
    genome, input_bam, jparams, params = fixture
    out = tmp_path / f"{dispatcher}_dispatcher.bam"
    if dispatcher == "port":
        _dispatch("port", genome, input_bam, out, params, [_jax_worker])
    else:
        _dispatch("jax", genome, input_bam, out, jparams, [_port_worker])
    _check_results(out)
    assert _sorted_records(out) == _sorted_records(jax_bam)


def test_port_dispatcher_requeues_a_dead_workers_chunk(fixture, tmp_path):
    """tests/test_integration.py::test_distributed_worker_death_requeues on
    the port: a worker that takes a task sheet and drops the connection
    loses no chunk."""
    genome, input_bam, _, params = fixture
    out = tmp_path / "faulty.bam"
    port = free_port()
    dispatcher = Dispatcher(str(input_bam), str(genome), str(out), False,
                            params, None, cmdline="mapad map")
    d_thread = threading.Thread(target=dispatcher.run, args=(port,),
                                daemon=True)
    d_thread.start()
    taken = []

    def faulty_worker():
        for _ in range(200):
            try:
                sock = socket.create_connection(("127.0.0.1", port))
                break
            except ConnectionRefusedError:
                time.sleep(0.05)
        msg = twire.read_message(sock)
        taken.append(twire.decode_task_sheet(msg[1]))
        sock.close()  # dies with an assigned, unanswered task

    f_thread = threading.Thread(target=faulty_worker, daemon=True)
    f_thread.start()
    f_thread.join(timeout=30)
    assert len(taken) == 1 and taken[0].chunk_id == 0
    assert len(taken[0].records) == CHUNK
    time.sleep(0.3)
    g_thread = threading.Thread(target=_serve, args=(_port_worker(port),),
                                daemon=True)
    g_thread.start()
    g_thread.join(timeout=JOIN_S)
    d_thread.join(timeout=JOIN_S)
    assert not d_thread.is_alive() and not g_thread.is_alive()
    _check_results(out)


# --- the bytes on the wire ---


def _models(pkg):
    models = __import__(f"{pkg}.models", fromlist=["x"])
    adna = models.SimpleAncientDnaModel(
        ("single_stranded", 0.6, 0.55), 0.01, 1.0,
        np.float32(0.02) / np.float32(3.0), False)
    ds = models.SimpleAncientDnaModel(
        ("double_stranded", 0.475), 0.02, 0.9,
        np.float32(0.03) / np.float32(3.0), True)
    return {"adna_ss": adna, "adna_ds_ignore_bq": ds,
            "vindija": models.VindijaPwm(),
            "test": models.TestDifferenceModel(-0.5, -1.0, 0.0)}


def _bound(pkg, kind, repr_mm):
    models = __import__(f"{pkg}.models", fromlist=["x"])
    return {"discrete": lambda: models.Discrete(0.03, 0.02, repr_mm),
            "continuous": lambda: models.Continuous(-1.5, 1.0, repr_mm),
            "testbound": lambda: models.TestBound(-2.0, repr_mm)}[kind]()


def _params(pkg, model, bound):
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    dm = _models(pkg)[model]
    repr_mm = dm.get_representative_mismatch_penalty()
    return mapping.AlignmentParameters(
        difference_model=dm, mismatch_bound=_bound(pkg, bound, repr_mm),
        penalty_gap_open=repr_mm * np.float32(1.5),
        penalty_gap_extend=repr_mm * np.float32(0.5), chunk_size=7,
        gap_dist_ends=5, stack_limit_abort=bound == "continuous",
        max_num_gaps_open=2)


def _records(pkg):
    rec = __import__(f"{pkg}.map.record", fromlist=["x"])
    return [
        rec.Record(sequence=b"ACGTTGCANNA", base_qualities=bytes(range(11)),
                   name=b"r0", bam_tags=[(b"XI", "Z", b"ACG"),
                                         (b"FF", "i", 3)], bam_flags=16),
        rec.Record(sequence=b"TTAGG", base_qualities=b"\x1e" * 5, name=None),
    ]


def _hits(pkg):
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    fmd = __import__(f"{pkg}.index.fmd", fromlist=["x"])
    return [
        [mapping.HitInterval(fmd.BiInterval(12, 40, 2), np.float32(-3.25),
                             [mapping.EditOperation(k, p, b)
                              for k, p, b in ((0, 0, 0), (1, 3, 2),
                                              (3, 7, 1), (2, 9, 0))])],
        [],
    ]


def _sheets(pkg, params):
    """A first task sheet (with the reference path and the parameters), a
    later one (without) and a result sheet, as `pkg` encodes them."""
    wire = __import__(f"{pkg}.distributed.wire", fromlist=["x"])
    sniff = __import__(f"{pkg}.io.sniff", fromlist=["x"])
    recs = _records(pkg)
    first = sniff.TaskSheet(3, recs, reference_path="/data/ref.fa",
                            alignment_parameters=params)
    results = list(zip(recs, _hits(pkg), (0.125, 3.0)))
    return (wire.encode_task_sheet(first),
            wire.encode_task_sheet(sniff.TaskSheet(4, recs)),
            wire.encode_result_sheet(3, results))


@pytest.mark.parametrize("bound", ["discrete", "continuous", "testbound"])
@pytest.mark.parametrize("model", ["adna_ss", "adna_ds_ignore_bq", "vindija",
                                   "test"])
def test_port_wire_bytes_equal_the_jax_packages(model, bound):
    ours, theirs = (_params("mapad_tpu_torch", model, bound),
                    _params("mapad_tpu", model, bound))
    assert twire.params_to_json(ours) == jwire.params_to_json(theirs)
    back = twire.params_from_json(jwire.params_to_json(theirs))
    assert twire.params_to_json(back) == jwire.params_to_json(theirs)

    jax_sheets = _sheets("mapad_tpu", theirs)
    assert _sheets("mapad_tpu_torch", ours) == jax_sheets

    # the port decodes the JAX package's sheets into the same messages
    first, _later, result = (m[jwire.HEADER.size:] for m in jax_sheets)
    task = twire.decode_task_sheet(first)
    assert task.reference_path == "/data/ref.fa" and task.chunk_id == 3
    assert twire.encode_task_sheet(task) == jax_sheets[0]
    chunk_id, results = twire.decode_result_sheet(result)
    assert twire.encode_result_sheet(chunk_id, results) == jax_sheets[2]


# --- the worker's engine ---


def test_port_worker_without_a_device_raises_without_cuda(monkeypatch):
    """No device named: the card, and without CUDA an error before the
    worker connects, not the host oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("127.0.0.1", free_port())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("127.0.0.1", free_port(), device="cuda:0")
    assert Worker("127.0.0.1", 1, device="cpu").device == torch.device("cpu")


def test_port_worker_builds_the_pool_engine_and_keeps_it(fixture,
                                                         monkeypatch):
    """The worker's engine is the pool-mode DeviceSearchEngine on the
    device asked for, built at the first chunk, kept for the next, and
    built again when a task sheet brings new parameters."""
    from mapad_tpu_torch.io.sniff import TaskSheet
    from mapad_tpu_torch.map.record import Record

    genome, _, _, params = fixture
    made = []

    class Spy(DeviceSearchEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr("mapad_tpu_torch.ops.engine.DeviceSearchEngine", Spy)
    recs = [Record(sequence=b"TTAACAATGAACTTAGGGAACGACCAGG",
                   base_qualities=bytes([40] * 28), name=b"r%d" % i)
            for i in range(3)]
    other = dataclasses.replace(params, max_num_gaps_open=1)
    sheets = [TaskSheet(0, recs[:1], str(genome), params),
              TaskSheet(1, recs[1:2]), TaskSheet(2, recs[2:], None, other)]
    results = []
    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen()
        worker = _port_worker(listener.getsockname()[1])
        w_thread = threading.Thread(target=worker.run, daemon=True)
        w_thread.start()
        conn, _ = listener.accept()
        with conn:
            conn.settimeout(JOIN_S)
            for sheet in sheets:
                conn.sendall(twire.encode_task_sheet(sheet))
                msg_type, payload = twire.read_message(conn)
                assert msg_type == twire.MSG_RESULT
                results.append(twire.decode_result_sheet(payload))
    w_thread.join(timeout=JOIN_S)
    assert not w_thread.is_alive()
    assert [c for c, _ in results] == [0, 1, 2]
    assert len(made) == 2 and worker.engine is made[1]
    for engine, p in zip(made, (params, other)):
        assert engine.mode == "pool" and engine.device == torch.device("cpu")
        assert engine.pool_config.lanes == 8 and engine.parameters is not p
        assert engine.parameters.max_num_gaps_open == p.max_num_gaps_open
    for _, [(record, hits, _)] in results:
        assert len(hits) == 1 and hits[0].interval.size == 1
