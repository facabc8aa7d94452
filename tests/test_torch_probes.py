"""The plain versions of the probe kernels P1-P4 (mapad_tpu_torch/tools/dma.py)
against the Pallas kernels of tools/bench_dma.py, tools/_probe_shapes.py,
tools/_t9.py and tools/_dump_pair.py, run in interpret mode on the CPU.

Those tools run their probes when imported (and _dump_pair.py patches the
TPU compiler), so they are not imported: each kernel body and its call site
is taken out of the tool's source with `ast` and run here with a `pl` whose
`pallas_call` interprets.  Every comparison is bit-exact (f32 by its bits);
where the TPU kernel leaves an output undefined (interpret mode fills it
with INT_MIN), only the written slice is compared.
"""

from __future__ import annotations

import ast
import functools
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mapad_tpu_torch.tools import _dump_pair, _probe_shapes, _t9  # noqa: E402
from mapad_tpu_torch.tools import dma  # noqa: E402

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


def _tool_tree(name):
    path = os.path.join(TOOLS, name)
    return path, ast.parse(open(path).read(), filename=path)


def _tool_defs(name, *defs, **env):
    """Run the named top-level functions of tools/<name> in a namespace of
    their own (`env` on top of JAX, with an interpreting `pl`)."""
    path, tree = _tool_tree(name)
    nodes = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in defs]
    assert sorted(n.name for n in nodes) == sorted(defs), defs
    ns = _namespace(**env)
    exec(compile(ast.Module(body=nodes, type_ignores=[]), path, "exec"), ns)
    return ns


def _namespace(**env):
    interp = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return dict(jax=jax, jnp=jnp, pl=interp, pltpu=pltpu,
                functools=functools, **env)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


# --- P1: tools/bench_dma.py scatter_dma_kernel ------------------------------


def _p1_inputs(nb, lanes, width, lo, hi, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(lo, hi, size=(nb, width), dtype=np.int32)
    blk = rng.integers(0, nb, size=lanes, dtype=np.int32)
    return rows, blk


def _p1_model(rows, blk, steps):
    """numpy f32 model of the TPU kernel, with the plain version's XOR of
    every word moved."""
    nb = rows.shape[0]
    acc, chk = np.float32(0), 0
    for t in range(steps):
        a7 = int(np.float32(acc).astype(np.int32)) % 7
        g = rows[(blk.astype(np.int64) + t * 1237 + a7) % nb]
        chk ^= int(np.bitwise_xor.reduce(g.ravel()))
        acc = np.float32(acc + np.float32(int(g[:, 0].astype(np.int64).sum())))
    return acc, np.int32(chk)


@pytest.mark.parametrize("nb,lanes,width,steps,lo,hi", [
    (4096, 8, 128, 3, 0, 100),         # the reference's values
    (1024, 13, 32, 5, -1000, 1000),    # negative acc: truncation, floor-mod
    (2048, 32, 64, 8, 0, 500_000),     # acc passes 2^24 and rounds
])
def test_gather_steps_plain_equals_pallas(nb, lanes, width, steps, lo, hi):
    rows, blk = _p1_inputs(nb, lanes, width, lo, hi, seed=nb + lanes)
    ns = _tool_defs("bench_dma.py", "scatter_dma_kernel", "run_scatter",
                    NB=nb)
    want = ns["run_scatter"](jnp.asarray(rows), jnp.asarray(blk), lanes,
                             steps, width)
    acc, chk = dma.gather_steps_plain(torch.from_numpy(rows),
                                      torch.from_numpy(blk), steps)
    assert _bits(acc.numpy()[0]) == _bits(np.asarray(want)[0, 0])
    m_acc, m_chk = _p1_model(rows, blk, steps)
    assert _bits(acc.numpy()[0]) == _bits(m_acc) and int(chk[0]) == m_chk
    if hi > 100_000:
        assert abs(float(acc[0])) > 2**24


@pytest.mark.parametrize("lo,hi", [(0, 16_000), (-16_000, 16_000)])
def test_gather_steps_plain_equals_f32_model_past_2_24(lo, hi):
    """At the probe's L=1024, W=128: acc passes 2^24 (values from 0) or
    swings through negative values, and its rounding follows f32."""
    rows, blk = _p1_inputs(8192, 1024, 128, lo, hi, seed=5)
    acc, chk = dma.gather_steps(torch.from_numpy(rows),
                                torch.from_numpy(blk), 24)
    m_acc, m_chk = _p1_model(rows, blk, 24)
    assert _bits(acc.numpy()[0]) == _bits(m_acc) and int(chk[0]) == m_chk
    if lo == 0:
        assert float(acc[0]) > 2**24


def test_gather_steps_one_step_at_a_time_equals_one_call():
    rows, blk = map(torch.from_numpy,
                    _p1_inputs(4096, 100, 128, 0, 100_000, seed=9))
    want = dma.gather_steps(rows, blk, 12)
    acc = chk = None
    for t in range(12):
        acc, chk = dma.gather_steps(rows, blk, 1, t0=t, acc=acc, chk=chk)
    assert torch.equal(acc.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(chk, want[1])
    part = dma.gather_steps(rows, blk, 5)
    rest = dma.gather_steps(rows, blk, 7, t0=5, acc=part[0], chk=part[1])
    assert torch.equal(rest[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(rest[1], want[1])


@pytest.mark.parametrize("what", ["blk", "sum", "index", "shape"])
def test_gather_steps_rejects_what_the_kernel_does_not_take(what):
    rows, blk = map(torch.from_numpy, _p1_inputs(64, 8, 16, 0, 100, seed=1))
    steps = 2
    if what == "blk":
        blk[3] = 64
    elif what == "sum":
        rows[5, 0] = 2**24 // 8
    elif what == "index":
        steps = 2**31 // 1237 + 1
    else:
        rows = rows[:, :8]
    with pytest.raises(ValueError):
        dma.gather_steps(rows, blk, steps)


# --- P2: tools/_probe_shapes.py src_slice / dst_slice -----------------------


def _arange_jnp():
    """jnp whose `zeros` fills with arange, so the tool's own call sites see
    distinct words."""
    ns = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("_")})
    ns.zeros = lambda shape, dtype: jnp.arange(
        math.prod(shape), dtype=dtype).reshape(shape)
    return ns


def _jax_slice(sl):
    return tuple(pl.ds(s.start, s.stop - s.start) for s in sl)


@pytest.mark.parametrize("case", _probe_shapes.SHAPES, ids=lambda c: c[0])
def test_probe_shapes_plain_equals_pallas(case):
    name, kind, shape, sl, blk = case
    row0, nrows, col0, ncols = _probe_shapes.slice_args(shape, sl)
    kernel, plain, library, want = _probe_shapes.case(kind, shape, sl, blk,
                                                      "cpu")
    for call in (kernel, plain, library):
        assert torch.equal(call(), want), "against torch slicing"
    for data in ("zeros", "arange"):
        ns = _tool_defs("_probe_shapes.py", "src_slice", "dst_slice")
        if data == "arange":
            ns["jnp"] = _arange_jnp()
        x = (np.zeros if data == "zeros" else
             lambda s, dtype: np.arange(math.prod(s), dtype=dtype).reshape(s))
        if kind == "src":
            jax_out = ns["src_slice"](shape, _jax_slice(sl), blk)
            plain = dma.copy_src_slice_plain(
                torch.from_numpy(x(shape, np.int32)), row0, nrows, col0,
                ncols).reshape(blk)
            assert np.array_equal(np.asarray(jax_out), plain.numpy()), data
        else:
            jax_out = ns["dst_slice"](shape, _jax_slice(sl), blk)
            out = torch.full(shape, -1, dtype=torch.int32)
            dma.copy_dst_slice_plain(torch.from_numpy(x(blk, np.int32)), out,
                                     row0, col0)
            assert np.array_equal(np.asarray(jax_out)[sl], out.numpy()[sl])
            assert (out.numpy()[:row0] == -1).all()
            assert (out.numpy()[row0 + nrows:] == -1).all()


# --- P3: tools/_t9.py t9 -------------------------------------------------------


def test_t9_plain_equals_pallas():
    rows = np.arange(_t9.NB * _t9.W, dtype=np.int32).reshape(_t9.NB, _t9.W)
    ns = _tool_defs("_t9.py", "k9", "t9", NB=_t9.NB, W=_t9.W,
                    rows=jnp.asarray(rows))
    got, want = _t9.run("cpu")
    assert torch.equal(got, want)
    assert np.array_equal(np.asarray(ns["t9"]()), got.numpy())


# --- P4: tools/_dump_pair.py k_src / k_dst ---------------------------------


def test_dump_pair_plain_equals_pallas():
    path, tree = _tool_tree("_dump_pair.py")
    rows = np.arange(8 * _dump_pair.W, dtype=np.int32).reshape(8, -1)
    ns = _tool_defs("_dump_pair.py", "k_src", "k_dst", W=_dump_pair.W,
                    rows=jnp.asarray(rows))
    # the two pallas_calls, as the tool makes them (:48-55, :61-68)
    calls = [n.body[0].value for n in tree.body if isinstance(n, ast.Try)]
    assert [c.func.args[0].id for c in calls] == ["k_src", "k_dst"]
    jax_src, jax_dst = (
        np.asarray(eval(compile(ast.Expression(body=c), path, "eval"), ns))
        for c in calls)
    pair = {what: (got, want) for what, got, want in _dump_pair.run_pair("cpu")}
    for got, want in pair.values():
        assert torch.equal(got, want)
    assert np.array_equal(jax_src, pair["k_src"][0].numpy())
    row = _dump_pair.DST_ROW
    assert np.array_equal(jax_dst[row], pair["k_dst"][0].numpy()[row])


@pytest.mark.parametrize("what", ["rows", "cols", "wide", "overlap"])
def test_copy_slices_reject_what_the_kernels_do_not_take(what):
    x = torch.arange(64 * 128, dtype=torch.int32).reshape(64, 128)
    with pytest.raises(ValueError):
        if what == "rows":
            dma.copy_src_slice(x, 60, 8, 0, 128)
        elif what == "cols":
            dma.copy_dst_slice(x[:2], x.new_zeros(8, 130), 0, 3)
        elif what == "wide":
            dma.copy_src_slice(x.new_zeros(2, 10_000), 0, 1, 0, 10_000)
        else:
            dma.copy_dst_slice(x[:2], x, 4, 0)
