"""The C++ oracle (``feos_tpu.cpu_backend``) for the port's tests.

``from _torch_oracle import backend`` gives a test module the ``backend``
fixture.  Every pytest worker builds ``csrc/libfeos_cpu.so`` on its first
load, and a load that finds the file half written by another worker fails,
so the fixture retries a few times, 2 s apart, before the tests use it.
"""

import time

import pytest

from feos_tpu import cpu_backend


@pytest.fixture(scope="module")
def backend():
    """``cpu_backend`` once its library loads."""
    for _ in range(10):
        if cpu_backend.available():
            break
        time.sleep(2.0)
    return cpu_backend
