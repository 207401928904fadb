"""Shared utilities: recursive dict transforms and profile plotting.

Capability spec from ``/root/reference/utils.py:9-53``.
"""

from __future__ import annotations

import contextlib

import numpy as np

_HOST_CPU = None


def _host_cpu_device():
    """The local CPU jax device, or None if the CPU backend is absent."""
    global _HOST_CPU
    if _HOST_CPU is None:
        import jax
        try:
            _HOST_CPU = jax.local_devices(backend="cpu")[0]
        except Exception:  # noqa: BLE001 — cpu plugin not registered
            _HOST_CPU = False
    return _HOST_CPU or None


def configure_jit_cache():
    """Point jax at the persistent compile cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and nothing else is set.  Otherwise the cache lives at
    the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``): the
    path is part of the cache key, so it must not move between runs.
    A cache the process configured itself is left alone.

    ``PYSURFINV_JIT_CACHE=0|off|disable|none`` turns the persistent
    cache OFF even for entry points that self-configure one
    (``invert_grid``, ``bench.py``) and returns None.  The test suite
    sets it: jaxlib 0.9.0's XLA:CPU executable (de)serialization
    segfaults under process load (see tests/conftest.py), and a
    mid-suite ``invert_grid`` call must not silently re-enable the
    cache the suite disabled.
    """
    import os

    import jax

    env = os.environ.get("PYSURFINV_JIT_CACHE")
    if env is not None and env.strip().lower() in ("0", "off", "disable",
                                                   "none", ""):
        return None
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    if jax.config.jax_compilation_cache_dir:
        return jax.config.jax_compilation_cache_dir
    cache_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


@contextlib.contextmanager
def host_eager():
    """Pin eager (non-jit) jnp ops inside the block to the local CPU.

    The dual host/traced layer classes run their host-mode math as
    eager jnp ops: thousands of scalar-sized operations that each cost
    a kernel launch and a device round trip on an accelerator, and
    next to nothing on the host CPU.  Traced (jit) calls are unaffected
    — a trace context ignores the default-device setting — so the
    dual-mode classes need no changes; only host-only entry points opt
    in.

    Callers must materialise results to numpy before leaving the block
    (every current caller already does): arrays committed to the CPU
    device would otherwise pull later eager math — or a jit call with
    no explicit sharding — onto the CPU silently.
    """
    dev = _host_cpu_device()
    if dev is None:
        yield
        return
    import jax
    with jax.default_device(dev):
        yield


def savez_fast(path, compresslevel=1, **arrays):
    """``np.savez_compressed`` at a chosen deflate level (numpy pins the
    zlib default, level 6).  MCMC chain files are dominated by repeated
    rejected-step rows, which level-1 deflate already collapses —
    measured ~1.6x faster at identical size on a synthetic 24k-sample
    track.  ``np.load`` reads the result identically."""
    import zipfile
    from numpy.lib import format as npformat
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=compresslevel) as zf:
        for name, val in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                npformat.write_array(fh, np.asarray(val),
                                     allow_pickle=True)


def npy_bytes(val, allow_pickle=True):
    """Serialize one array to ``.npy`` bytes (what ``np.savez`` stores
    per entry)."""
    import io
    from numpy.lib import format as npformat
    fh = io.BytesIO()
    npformat.write_array(fh, np.asarray(val), allow_pickle=allow_pickle)
    return fh.getvalue()


def npy_header_bytes(shape, dtype):
    """The ``.npy`` header (magic + dict) for a C-order array of the
    given shape/dtype — the first bytes of the entry ``np.save`` would
    write, with ``array.tobytes()`` following."""
    import io
    from numpy.lib import format as npformat
    fh = io.BytesIO()
    npformat.write_array_header_1_0(
        fh, {"descr": npformat.dtype_to_descr(np.dtype(dtype)),
             "fortran_order": False, "shape": tuple(shape)})
    return fh.getvalue()


class StreamingLaneCompressor:
    """Deflate MCMC chain rows lane-by-lane WHILE later segments are
    still executing on the device.

    The end-of-run npz write is zlib-bound and strictly serial on a
    1-core host (measured ~22 s for 256 points x 24k samples, ~24% of
    the whole ``invert_grid`` wall time).  But during the segment loop
    the host CPU is idle — it sits in device->host fetches (network /
    PCIe bound, GIL released).  This class moves the zlib work into
    that slack: one raw-deflate stream per (point, chain) lane, fed
    each committed segment's rows in time order (which IS the final
    byte order within a lane, since the reference's ``mcTrack`` layout
    is chain-major: ``point.py:114-121`` concatenates each chain's full
    track).  Per-lane streams end with ``Z_FULL_FLUSH`` — byte-aligned,
    window-independent — so a point's entry is assembled at write time
    by *concatenating* its lanes' compressed chunks and appending a
    2-byte final block: no recompression.  ``np.load`` reads the result
    identically to ``savez_fast`` output (one valid deflate stream).

    Feeds run on a single worker thread (zlib releases the GIL), so
    compression overlaps the main thread's blocking fetches even with
    one CPU.
    """

    def __init__(self, n_lanes, level=1):
        import queue
        import threading
        import zlib
        self._zlib = zlib
        self._objs = [zlib.compressobj(level, zlib.DEFLATED, -15)
                      for _ in range(n_lanes)]
        self._chunks = [[] for _ in range(n_lanes)]
        self._q = queue.Queue()
        self._err = None
        self._closed = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                buf, s0, s1 = item
                for lane, obj in enumerate(self._objs):
                    # buf is (n_lanes, chainL, w) C-order: the slice is
                    # a contiguous view, zlib consumes it buffer-direct
                    c = obj.compress(buf[lane, s0:s1])
                    if c:
                        self._chunks[lane].append(c)
            except Exception as e:  # noqa: BLE001 — surfaced in close()
                self._err = e

    def feed(self, buf, s0, s1):
        """Queue rows [s0:s1) of every lane (buf = the lane-major track
        buffer; the fed region must never be written again)."""
        self._q.put((buf, s0, s1))

    def close(self):
        """Drain the queue and finalize every lane's stream."""
        if not self._closed:
            self._q.put(None)
            self._t.join()
            if self._err is not None:
                raise self._err
            for lane, obj in enumerate(self._objs):
                self._chunks[lane].append(
                    obj.flush(self._zlib.Z_FULL_FLUSH))
            self._closed = True

    def abort(self):
        """Stop the worker without finalizing (error-path cleanup)."""
        if not self._closed:
            self._q.put(None)
            self._t.join()
            self._closed = True

    def lane_chunks(self, lo, hi):
        """Compressed chunks of lanes [lo:hi) (call close() first)."""
        assert self._closed
        out = []
        for lane in range(lo, hi):
            out.extend(self._chunks[lane])
        return out


#: final empty deflate block terminating a concatenated raw stream
DEFLATE_TERMINATOR = b"\x03\x00"


def write_npz_precompressed(path, entries):
    """Write a ``np.load``-compatible npz from already-deflated data.

    ``entries`` is a list of ``(name, raw_size, crc32, parts)`` where
    ``parts`` is a list of compressed byte chunks forming one valid
    deflate stream for the entry named ``name`` (``.npy`` suffix is
    appended here, matching ``np.savez``).  The zip container is
    assembled by hand because :mod:`zipfile` has no public API for
    inserting precompressed data.  DOS timestamps are pinned to the
    epoch (1980-01-01), like ``savez_fast``'s default ``ZipInfo``.
    """
    import struct
    LIMIT = 0xFFFFFFFF - 1
    recs = []
    with open(path, "wb") as f:
        for name, raw_size, crc, parts in entries:
            nb = (name + ".npy").encode()
            csize = sum(len(p) for p in parts)
            off = f.tell()
            if raw_size > LIMIT or csize > LIMIT or off > LIMIT:
                raise OverflowError("zip64 entry in precompressed npz")
            # local file header: sig, extract-version, flags, method,
            # dos time, dos date, crc, csize, usize, namelen, extralen
            f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 20, 0, 8,
                                0, 0x21, crc, csize, raw_size,
                                len(nb), 0))
            f.write(nb)
            for p in parts:
                f.write(p)
            recs.append((nb, raw_size, crc, csize, off))
        cd0 = f.tell()
        for nb, raw_size, crc, csize, off in recs:
            # central directory: sig, made-by, extract-version, flags,
            # method, time, date, crc, csize, usize, namelen, extralen,
            # commentlen, disk#, int attrs, ext attrs, local offset
            f.write(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 20,
                                20, 0, 8, 0, 0x21, crc, csize,
                                raw_size, len(nb), 0, 0, 0, 0, 0, off))
            f.write(nb)
        cd_size = f.tell() - cd0
        # end of central directory
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(recs),
                            len(recs), cd_size, cd0, 0))


def deflate_bytes(data, level=1):
    """One-shot raw deflate of ``data`` -> (crc32, [stream bytes])."""
    import zlib
    obj = zlib.compressobj(level, zlib.DEFLATED, -15)
    return zlib.crc32(data), [obj.compress(data) + obj.flush()]


def _dictIterModifier(d, checker, modifier):
    """Recursively walk dicts/lists, replacing values that pass ``checker``.

    The workhorse behind YAML<->Brownian conversion and perturbation
    (utils.py:9-30 of the reference).
    """
    if type(d) is dict:
        out = {}
        for k, v in d.items():
            if checker(v):
                out[k] = modifier(v)
            elif type(v) in (dict, list):
                out[k] = _dictIterModifier(v, checker, modifier)
            else:
                out[k] = v
        return out
    if type(d) is list:
        out = []
        for v in d:
            if checker(v):
                out.append(modifier(v))
            elif type(v) in (dict, list):
                out.append(_dictIterModifier(v, checker, modifier))
            else:
                out.append(v)
        return out
    return d


def plotLayer(h, v, fig=None, ax=None, label=None, **kwargs):
    """Staircase profile plot from layer thicknesses (utils.py:32-42)."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure(figsize=[5, 7])
        ax = plt.gca()
    else:
        plt.sca(ax)
    h = np.asarray(h)
    v = np.asarray(v)
    hNew = np.insert(np.repeat(np.cumsum(h), 2)[:-1], 0, 0)
    vNew = np.repeat(v, 2)
    ax.plot(vNew, hNew, label=label, **kwargs)
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax


def plotGrid(zdepth, v, fig=None, ax=None, label=None, **kwargs):
    """Grid-point profile plot (utils.py:44-53)."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure(figsize=[5, 7])
        ax = plt.gca()
    else:
        plt.sca(ax)
    ax.plot(np.asarray(v), np.asarray(zdepth), label=label, **kwargs)
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax
