"""The port stands alone: no module of mapad_tpu_torch and not chip_smoke.py
imports JAX or anything of mapad_tpu, and the device engine never falls
back to the CPU on its own."""

import ast
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mapad_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "mapad_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    """Top-level package of every absolute import in the file, including
    imports inside functions."""
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_mapad_tpu():
    files = _port_files()
    assert os.path.exists(files[0]), "chip_smoke.py is missing"
    assert len(files) > 30
    parallel = {os.path.relpath(f, ROOT) for f in files
                if os.sep + "parallel" + os.sep in f}
    assert {f"mapad_tpu_torch/parallel/{m}.py"
            for m in ("sharding", "pool_sharded", "multihost")} <= parallel
    # CRAM input, the mapAD-native index and distributed mode; big mode's
    # tools; the sheet-boundary readings of long runs
    assert {f"mapad_tpu_torch/{m}.py" for m in (
        "io/rans_nx16", "io/arith", "io/fqzcomp", "io/tok3", "io/cram",
        "index/mapad_native", "distributed/wire", "distributed/dispatcher",
        "distributed/worker", "tools/big_rows", "tools/measure_big",
        "tools/load_time", "tools/assembly", "tools/configs",
        "tools/sheets", "tools/stream_stall")} <= {
            os.path.relpath(f, ROOT) for f in files}
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        # "mapad_tpu_torch" shares the prefix but is its own root
        assert not bad, (os.path.relpath(path, ROOT), bad)


def test_import_check_sees_the_shared_prefix(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import mapad_tpu_torch.ops\n"
                 "def f():\n    from mapad_tpu.ops import engine\n")
    assert _imported_roots(str(p)) == {"mapad_tpu_torch", "mapad_tpu"}


def test_engine_without_device_raises_without_cuda(monkeypatch):
    from mapad_tpu_torch.index.builder import build_auxiliary_structures
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from torch_port_helpers import adna_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fmd, _ = build_auxiliary_structures(b"ACGTTGCAACGGTACA" * 8, b"ACGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"))


def test_index_without_device_raises_without_cuda(monkeypatch):
    """The index constructors default to the card like the engine does."""
    from mapad_tpu_torch.index.builder import build_auxiliary_structures
    from mapad_tpu_torch.ops.fm import DeviceFmIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fmd, _ = build_auxiliary_structures(b"ACGTTGCAACGGTACA" * 8, b"ACGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFmIndex.from_host(fmd)
    on_cpu = DeviceFmIndex.from_host(fmd, device="cpu")
    assert on_cpu.rows.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFmIndex.from_numpy(on_cpu.rows.numpy(), on_cpu.less.numpy(),
                                 on_cpu.sentinels.numpy(), on_cpu.occ_k,
                                 on_cpu.text_len)


@pytest.mark.parametrize("tool", ["bench_dma", "_probe_shapes", "_t9",
                                  "_dump_pair"])
def test_probe_tools_raise_without_cuda(monkeypatch, tool):
    """The ports of the TPU's DMA probes run on the card, or on the CPU only
    when asked (`device="cpu"`): never on the CPU because no card is there."""
    import importlib

    mod = importlib.import_module(f"mapad_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(*([[]] if tool == "_dump_pair" else []))
    entry = {"bench_dma": "make_inputs", "_probe_shapes": "check",
             "_t9": "run", "_dump_pair": "run_pair"}[tool]
    args = (64, 8, 8) if tool == "bench_dma" else ()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(mod, entry)(*args)
