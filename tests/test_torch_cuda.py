"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes that reach the edge cases (abandon markers, chain
log overflow, an exhausted step budget, the RLE and raw Bi-D blobs).

Needs an NVIDIA GPU with nvcc; skips elsewhere.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import (  # noqa: E402
    adna_params,
    bench_reads,
    bench_ref,
    records,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from mapad_tpu_torch import _build

    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    _build.build_cuda()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fmd():
    from mapad_tpu_torch.index.builder import build_auxiliary_structures

    return build_auxiliary_structures(bench_ref(), b"ACGT")[0]


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (what, k, int((g != w).sum()))


def _prepped(fmd, cuda, cfg_kw, seed, rle=True, monkeypatch=None):
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig

    if not rle:
        monkeypatch.setenv("MAPAD_BID_RLE", "0")
    eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                             pool_config=PoolConfig(**cfg_kw), device=cuda)
    recs = records("mapad_tpu_torch", bench_reads(seed=seed))
    cfg, prep, _ = eng._prep_block(recs, 48, eng.pool_config)
    return eng, cfg, prep


@pytest.mark.parametrize("rle", [True, False])
def test_unpack_prep_kernel(fmd, cuda, rle, monkeypatch):
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    eng, _cfg, prep = _prepped(fmd, cuda, dict(lanes=8, total_steps=256),
                               1, rle, monkeypatch)
    assert prep["rle"] == rle
    blob = torch.from_numpy(prep["blob"]).to(cuda)
    tab, off = eng._device_lut()
    R, M = prep["L"], prep["max_len"]
    got = teng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q, rle)
    want = teng._unpack_prep_lut_plain(blob, tab, off, R, M, _DEV_LUT_Q, rle)
    _equal(got, want, "unpack_prep")


def test_extend_batch_kernel(fmd, cuda):
    from mapad_tpu_torch.ops import fm

    idx = fm.DeviceFmIndex.from_host(fmd, device=cuda)
    rng = np.random.default_rng(3)
    n = idx.text_len
    lower = rng.integers(0, n, size=300).astype(np.int32)
    size = np.minimum(rng.integers(0, 50, size=300), n - lower).astype(np.int32)
    lower[:5] = 0
    size[:3] = n
    lrev = rng.integers(0, n, size=300).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda) for a in (lower, lrev, size)]
    _equal(fm.extend_batch(idx, *t), fm.extend_batch_plain(idx, *t), "K1")


CASES = {
    "bench": dict(lanes=8, total_steps=2048, read_step_cap=2048,
                  max_chains=512),
    "abandon": dict(lanes=8, total_steps=2048, read_step_cap=64,
                    max_chains=512),
    "overflow": dict(lanes=8, total_steps=2048, read_step_cap=2048,
                     max_chains=16),
    "budget": dict(lanes=8, total_steps=96, read_step_cap=64,
                   max_chains=512),
    "wide": dict(lanes=64, total_steps=512, read_step_cap=300,
                 max_chains=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("track", [True, False])
def test_pool_search_and_pack_kernels(fmd, cuda, case, track):
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import search_pool2 as sp2

    eng, cfg, prep = _prepped(fmd, cuda, CASES[case], seed=len(case))
    cfg = cfg._replace(track_read_steps=track)
    with torch.cuda.device(cuda):
        parts = eng._upload(prep)
        args = (eng.device_index, *parts[:5], eng._params(), cfg, parts[5])
        got = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*args), cfg)
        want = sp2._extract_chains_plain(*sp2._pool_loop_plain(*args), cfg)
        torch.cuda.synchronize()
    _equal(tuple(got), tuple(want), case)
    _equal((teng._pack_result(got),), (teng._pack_result_plain(got),),
           "pack_result")


def test_engine_on_the_card_equals_plain(fmd, cuda):
    """The whole device path (upload, K4, K2+K3, K5, the pinned copy on
    the side stream) against the same engine on the CPU's plain versions,
    over several streamed blocks."""
    from concurrent.futures import Future

    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from torch_port_helpers import packed_equal

    cfg = PoolConfig(lanes=16, total_steps=1024, read_step_cap=256,
                     max_chains=256)
    reads = records("mapad_tpu_torch", bench_reads(seed=4, n_random=60))
    outs = []
    for dev in (cuda, "cpu"):
        eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                                 pool_config=cfg, packed_hits=True,
                                 device=dev)
        eng.block_reads = 32
        res = eng.search_chunk(reads, lazy_fallback=True)
        outs.append(({i for i, r in enumerate(res) if isinstance(r, Future)},
                     [(r.result() if isinstance(r, Future) else r)[0]
                      for r in res], eng._stats["esc_why"]))
    (esc_g, hits_g, why_g), (esc_c, hits_c, why_c) = outs
    assert esc_g == esc_c and why_g == why_c
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))


def test_profile_trace_shows_the_kernels(cuda, tmp_path, monkeypatch):
    """`map --profile` on the card records the ctypes-launched kernels."""
    import json

    from mapad_tpu_torch.cli import main

    ref = bench_ref()
    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + ref.decode() + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n"
        for i, s in enumerate(bench_reads(seed=2, n_random=20))
    ))
    monkeypatch.setenv("MAPAD_POOL_STEPS", "1024")
    assert main(["index", "-g", str(fa)]) == 0
    assert main(["map", "-r", str(fq), "-g", str(fa), "-o",
                 str(tmp_path / "o.bam"), "-p", "0.03", "-l",
                 "single_stranded", "-f", "0.6", "-t", "0.55", "-d", "0.01",
                 "-s", "1.0", "-i", "0.001", "--profile",
                 str(tmp_path / "trace")]) == 0
    events = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name", "") for e in events.get("traceEvents", [])}
    for kernel in ("pool_lane_kernel", "pool_refill_kernel",
                   "unpack_prep_kernel", "pack_result_kernel"):
        assert any(kernel in n for n in names), kernel
