"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding (hash-sharded sketches, data-parallel read batches)
is exercised on host devices.  The GPU path is checked by ``chip_smoke.py``
(see README), not by these tests.  The platform goes through jax.config so
it holds even when JAX was imported before this file.
"""

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_logstream():
    """Keep the logging globals test-local.

    The CLI entry point binds ``kevlar_tpu.logstream`` to the *current*
    ``sys.stderr`` — under capsys that's a per-test capture object, and
    leaving it bound leaks one test's capture into the next (plog output
    then bypasses the later test's capsys).  Reset to the dynamic default
    around every test.
    """
    import kevlar_tpu
    kevlar_tpu.logstream = None
    kevlar_tpu.teelog = False
    yield
    kevlar_tpu.logstream = None
    kevlar_tpu.teelog = False


@pytest.fixture
def datadir(tmp_path):
    return tmp_path
