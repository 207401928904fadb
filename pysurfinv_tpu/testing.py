"""Backend-forcing helpers for tests, dry runs, and CI-style checks.

:func:`force_cpu` pins JAX to the host CPU with a chosen number of
virtual devices, from inside a process: it sets ``JAX_PLATFORMS`` and
``jax.config.jax_platforms`` before the backend initializes (on a
machine with a GPU, ``jax.config.update`` is what wins once ``jax`` is
already imported), and injects
``--xla_force_host_platform_device_count`` — ``XLA_FLAGS`` is read
lazily at backend-client creation, so it still takes effect after
``import jax`` as long as no computation has run yet.

Used by ``tests/conftest.py``, ``__graft_entry__.dryrun_multichip``,
and any script that must run on a virtual CPU mesh whatever hardware
the machine has.
"""

from __future__ import annotations

import os


def force_cpu(n_devices: int = 8, x64: bool = True):
    """Force JAX onto the host CPU backend with ``n_devices`` virtual devices.

    Must be called before the JAX backend is initialized.  Returns the
    ``jax`` module.  Raises ``RuntimeError`` if the backend ends up on a
    non-CPU platform or with fewer devices than requested (e.g. because
    it was already initialized on another platform).
    """
    flag = f"--xla_force_host_platform_device_count={n_devices}"
    # Replace (not just add) any inherited device-count flag: a
    # subprocess spawned from a test session inherits XLA_FLAGS with
    # the parent's count, which must not win over the requested one.
    kept = [f for f in os.environ.get("XLA_FLAGS", "").split()
            if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(kept + [flag])
    # Best effort — harmless where ignored, sufficient where respected.
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)

    devs = jax.devices()
    if not devs or devs[0].platform != "cpu":
        raise RuntimeError(
            f"force_cpu failed: backend initialized on {devs!r}; "
            "call force_cpu() before any JAX computation/import side "
            "effect that touches the backend.")
    if len(devs) < n_devices:
        raise RuntimeError(
            f"force_cpu got {len(devs)} CPU devices, wanted {n_devices}; "
            "XLA_FLAGS was read too late (backend already initialized?).")
    return jax
