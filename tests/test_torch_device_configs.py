"""tests/test_device_configs.py on the port: its five cases (the Continuous
bound, a double-stranded library, ignore_base_quality, the gap settings
(0, 1) and (10, 3), the pop ring's wraparound) run unchanged against
mapad_tpu_torch, the engine on the CPU's plain kernels, each read's hits
equal to the port's sequential oracle."""

import functools

import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import port_twin  # noqa: E402

_twin = port_twin("test_device_configs", subs=[(
    # the wraparound case's parameters, from the port's own classes
    "from tests.test_device_search import _adna_params",
    "from torch_port_helpers import port_adna_params as _adna_params",
)])
# the twin's engines run the plain kernels on the CPU
_twin["DeviceSearchEngine"] = functools.partial(_twin["DeviceSearchEngine"],
                                                device="cpu")
globals().update({k: v for k, v in _twin.items()
                  if k.startswith("test_") or k == "ref_fmd"})
