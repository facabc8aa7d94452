"""`map` of both CLIs under mapAD's other settings
(mapad_tpu_torch/tools/configs.py) on the integration fixture of
tests/test_integration.py (17 reads, deletions and insertions among
them): the port's `--engine device` on the CPU's plain kernels writes the
BAM that mapad_tpu's `--engine device` writes, record for record, MAPQ
and tags included (XD, a timing, aside), with the same header but the @PG
command line.  Also tests/test_integration.py's `-R` case on the port."""

import pytest

torch = pytest.importorskip("torch")

# the plain kernels run thousands of tiny tensor ops; one intra-op thread
# per test worker keeps them from spinning against the other workers
torch.set_num_threads(1)

from mapad_tpu.cli import main as j_main  # noqa: E402
from mapad_tpu_torch.cli import main as t_main  # noqa: E402
from mapad_tpu_torch.tools import configs  # noqa: E402
from test_integration import prepare  # noqa: E402
from test_torch_integration import _header_without_cl, _records  # noqa: E402
from torch_port_helpers import port_twin  # noqa: E402

# tests/test_integration.py's read-group case on the port's modules
test_integration_rg = port_twin("test_integration")["test_integration_rg"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("configs_cli")
    genome, input_bam, _params = prepare(tmp)
    return tmp, str(genome), str(input_bam)


@pytest.mark.parametrize("name", ["ds", "cutoff", "ibq", "no_gaps", "abort",
                                  "rg"])
def test_cli_map_under_a_setting_equals_jax(fixture, name, monkeypatch):
    tmp, genome, input_bam = fixture
    monkeypatch.setenv("MAPAD_POOL_STEPS", "1024")
    flags = configs.flags(name)
    common = ["map", "-r", input_bam, "-g", genome, "--engine", "device",
              "--lanes", "16", "--force_overwrite", *flags]
    port, jax_bam = str(tmp / f"port_{name}.bam"), str(tmp / f"jax_{name}.bam")
    assert t_main([*common, "-o", port, "--device", "cpu"]) == 0
    assert j_main([*common, "-o", jax_bam]) == 0
    (gh, got), (wh, want) = _records(port), _records(jax_bam)
    assert got == want
    assert _header_without_cl(gh) == _header_without_cl(wh)
    mapped = [r for r in got if not r[1] & 0x4]
    assert len(got) == 17 and mapped
    if name == "rg":
        assert "@RG\tID:configs\tSM:sample14" in gh.splitlines()
        assert all((b"RG", "Z", b"configs") in r[8] for r in got)
    # hits with a deletion or an insertion: none without gaps, some at
    # the production gap settings
    indels = any("D" in r[5] or "I" in r[5] for r in mapped)
    if name == "no_gaps":
        assert not indels
    elif name in ("ibq", "abort", "rg"):
        assert indels
