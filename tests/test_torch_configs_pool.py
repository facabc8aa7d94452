"""The port's pool search against the JAX package's under mapAD's other
`map` settings (mapad_tpu_torch/tools/configs.py, built by each package's
own CLI parser): a double-stranded library, the Continuous bound `-c`
(with `-e` 1.0 and 0.5: a per-read scale of len^e), `--ignore_base_quality`
and the gap settings (0, 1), (10, 3) and no gap at all, on reads with
deletions and insertions (tests/test_device_configs.py's).  One
invocation of the plain kernels (K4's rows, K2, K3) against the JAX pool
search, every PoolResult field bit for bit; then the int32 engine over
streamed blocks against the JAX engine: the escalated set and its causes,
every read's hits packed (intervals, f32 score bits, op words)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from test_device_configs import _reads  # noqa: E402
from test_torch_engine import _assert_same_run  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_pool_results_equal,
    bench_ref,
    config_params,
    run_pool_both,
)
from torch_port_helpers import unsharded_env  # noqa: E402,F401

# the settings of tests/test_device_configs.py, max_num_gaps_open 0 and
# `-c 1.0 -e 0.5`: (configs setting, flag changes, reads, seed, quality)
CASES = {
    "cutoff": ("cutoff", None, 16, 1, 40),
    "cutoff_e05": ("cutoff", {"-c": "1.0", "-e": "0.5"}, 16, 11, 40),
    "ds": ("ds", None, 16, 2, 40),
    "ibq": ("ibq", None, 16, 3, 11),
    "gaps_0_1": ("gaps_0_1", None, 16, 4, 40),
    "gaps_10_3": ("gaps_10_3", None, 16, 14, 40),
    "no_gaps": ("no_gaps", None, 16, 5, 40),
}
CFG = dict(max_len=128, lanes=16, total_steps=4096, read_step_cap=1024,
           max_chains=512)


@pytest.fixture(scope="module")
def indexes():
    ref = bench_ref()
    return build_auxiliary_structures(ref, b"ACGT")[0], t_build(ref, b"ACGT")[0]


def case_params(case):
    name, changes, n, seed, qual = CASES[case]
    return (lambda pkg: config_params(pkg, name, changes),
            _reads(bench_ref(), n, seed), qual)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_search_under_a_setting_equals_jax(indexes, case):
    params_of, reads, qual = case_params(case)
    jr, tr, _eng = run_pool_both(indexes[0], reads, len(reads),
                                 params_of=params_of, qual=qual,
                                 compute_forward_part=False, **{
                                     k: v for k, v in CFG.items()
                                     if k != "max_len"})
    assert_pool_results_equal(jr, tr, case)
    n = min(int(jr.n_chains), CFG["max_chains"])
    assert int((~jr.c_abandon[:n]).sum()) > 0, case

    jfmd, tfmd = indexes
    je = JEngine(jfmd, params_of("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False, **CFG),
                 packed_hits=True)
    te = TEngine(tfmd, params_of("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**CFG), packed_hits=True,
                 device="cpu")
    _esc, hits = _assert_same_run(je, te, reads, 8, True, qual)
    assert sum(len(h) > 0 for h in hits) > len(reads) // 4
    mb = te.parameters.mismatch_bound
    if case.startswith("cutoff"):
        # the reject test divides by len^e, which is not 1 here
        assert type(mb).__name__ == "Continuous"
        assert mb._scale_read_length(60) != np.float32(1.0)
