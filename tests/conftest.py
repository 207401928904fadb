"""Test configuration: CPU backend, 8 virtual devices, float64, jit cache."""

import os
import sys

# Tests always run on CPU with a virtual 8-device mesh for sharding tests
# (SURVEY.md §4.5) and float64 so golden comparisons are exact
# (testing.force_cpu).  Tests of the compiled GPU kernels carry the
# ``chip`` marker and skip here; see the ``gpu`` fixture below.
os.environ.setdefault("PYSURFINV_SCAN_UNROLL", "1")  # keep compiles fast
# narrow proposal rounds: tests run tiny lane counts, where the default
# 2048-wide flat budget unrolls a 64-draw key walk into every compile;
# results are bit-identical for any width (see mcmc._propose_batched)
os.environ.setdefault("PYSURFINV_PROPOSE_FLAT", "8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pysurfinv_tpu.testing import force_cpu  # noqa: E402

jax = force_cpu(n_devices=8, x64=True)

# The persistent compile cache is DISABLED for the test suite by default.
# jaxlib 0.9.0's XLA:CPU executable (de)serialization segfaults under
# process load: three independent full-suite runs crashed at the ~88th
# test, first inside ``LoadedExecutable.serialize()`` (cache write), then
# — with writes gated — inside ``backend.deserialize_executable`` (cache
# read, jax/_src/compilation_cache.py:238) on an entry that reads fine in
# a fresh process, then — with the conftest cache config removed — inside
# ``put_executable_and_time`` again, because ``invert_grid`` self-
# configures a cache via ``utils.configure_jit_cache``.  There is no
# config gate for reads, so the only robust fix is to run the whole
# suite without a persistent cache: PYSURFINV_JIT_CACHE=0 below makes
# ``configure_jit_cache`` a no-op so mid-suite product calls cannot
# re-enable it.  The product path is unaffected (the crash is
# XLA:CPU-only; GPU runs keep utils.configure_jit_cache's cache).
# For fast single-module dev iteration, opt back in with
# PYSURFINV_TEST_JIT_CACHE=<dir>.
_cache_dir = os.environ.get("PYSURFINV_TEST_JIT_CACHE")
if _cache_dir:
    os.environ["PYSURFINV_JIT_CACHE"] = _cache_dir
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
else:
    os.environ["PYSURFINV_JIT_CACHE"] = "0"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# NOTE: full-suite runs appeared to die
# "before printing the summary line".  The real cause was pytest.ini's
# `addopts = -q` combining with the habitual `pytest -q` into -qq
# ("really quiet"), which suppresses the final "N passed" line BY
# DESIGN — the process exited rc=0 every time.  addopts no longer
# carries -q; see pytest.ini.

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "test1.npz")


@pytest.fixture(scope="session")
def golden():
    """Parsed TEST1 golden data (see tests/golden/make_golden.py)."""
    return np.load(GOLDEN)


@pytest.fixture(scope="session")
def eus_model(golden):
    """The 68-layer eus_model padded to L=72 (halfspace replicated, h=0)."""
    h, vp, vs = golden["model_h"], golden["model_vp"], golden["model_vs"]
    rho, qs = golden["model_rho"], golden["model_qs"]
    nlay = len(h)
    L = 72

    def pad(x, fill):
        return np.concatenate([x, np.full(L - nlay, fill)])

    return {
        "h": pad(h, 0.0).copy(),
        "vp": pad(vp, vp[-1]),
        "vs": pad(vs, vs[-1]),
        "rho": pad(rho, rho[-1]),
        "qsinv": pad(1.0 / qs, 1.0 / qs[-1]),
        "nlay": nlay,
        "periods": golden["periods"].astype(float),
    }


@pytest.fixture
def gpu():
    """The GPU device for ``@pytest.mark.chip`` tests; skips without one.

    Decided here, at run time, never at import or collection time: the
    xdist workers must all collect the same tests.  This suite pins JAX
    to the CPU, so chip tests run through ``python chip_smoke.py`` on a
    machine with a card.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); "
                    "run python chip_smoke.py on the card")
    return dev


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop live compiled executables at every module boundary.

    jaxlib 0.9.0's XLA:CPU backend segfaults *inside a fresh
    compilation* (``backend_compile_and_load``) once a single process
    has accumulated enough live executables — reproduced at the ~86th
    test of the full suite (test_parallel_grid's shard_map sampler
    program), while the same test passes alone.  The persistent-cache
    serialize/deserialize crashes documented above are the same
    underlying fragility on its other entry points.  Releasing every
    cached executable between modules keeps the process-wide live-
    executable count bounded by the heaviest single module.
    """
    yield
    import gc
    jax.clear_caches()
    gc.collect()
