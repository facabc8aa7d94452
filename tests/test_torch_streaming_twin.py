"""The JAX package's streaming-driver tests (tests/test_integration.py) on
the port, through `port_twin`: the integration fixture through
`pipeline.run` over the pool engine in blocks of 8 (the goldens hold), and
sheets of 9 reads sliced into blocks of 4 (the BAM equals the sequential
oracle's record for record, XD aside).  The twin's engine runs the plain
kernels (`device="cpu"`)."""

import pytest

pytest.importorskip("torch")

from torch_port_helpers import port_twin  # noqa: E402

_twin = port_twin("test_integration", subs=[(
    "pool_config=cfg, packed_hits=packed,",
    'pool_config=cfg, packed_hits=packed, device="cpu",')])

test_integration_device_streaming = _twin["test_integration_device_streaming"]
test_streaming_block_slicing_matches_oracle = _twin[
    "test_streaming_block_slicing_matches_oracle"]
