"""chip_smoke.py's guard and comparison helper, checked on the CPU.

The script itself needs a GPU (see README); here it must refuse to run,
and its array comparison must catch the smallest possible count error.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, 'chip_smoke.py')


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_refuses_to_run_on_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert 'JAX_PLATFORMS=cpu' in out.stderr


def test_array_comparison_catches_one_count_off_by_one():
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(0)
    want = rng.integers(0, 255, size=(4, 101), dtype=np.uint8)
    smoke.assert_equal_arrays('tables', want.copy(), want)
    got = want.copy()
    got[2, 57] += 1
    with pytest.raises(smoke.SmokeFailure,
                       match='tables: 1 of 404 elements differ; first at '
                             'flat index 259'):
        smoke.assert_equal_arrays('tables', got, want)
    with pytest.raises(smoke.SmokeFailure, match='shape'):
        smoke.assert_equal_arrays('tables', got[:3], want)
