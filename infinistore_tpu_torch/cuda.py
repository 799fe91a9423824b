"""CUDA device edge: move KV pages between GPU memory and the store.

The counterpart of ``infinistore_tpu/tpu.py``, and the path the
reference itself takes on a GPU: ``cudaMemcpyAsync`` between device
memory and the pool blocks, with no host staging.

- **put, SHM**: allocate, then copy each device page straight into its
  pool block (``cudaMemcpyAsync`` device->host on pinned pool memory;
  pages whose blocks are adjacent in one pool go as one copy), then
  synchronize, then ``commit``. FAKE blocks (first-writer-wins dedup)
  are skipped. No staging copy is made (``copy_counters``).
- **get, SHM**: pin, copy from the pool views into one device tensor,
  synchronize, and only then ``release`` the lease: the server may reuse
  the blocks as soon as the lease is gone.
- **pool registration**: each pool view is page-locked once with
  ``cudaHostRegister`` (pools added by auto-extension are registered as
  they appear) and unregistered on ``close``.
- **STREAM** (remote server): bytes go through a pinned staging buffer
  and ``write_cache`` / ``read_cache``.
- **LayerStreamer**: per-layer offload overlapped with compute — the
  layer's device->host copy runs on a side stream behind an event, and
  an upload thread waits on that event.

CPU tensors take the same paths with plain memcpys (the tests run so).
"""

import queue
import threading

import numpy as np
import torch

from ._device import resolve_device
from ._native import FAKE_TOKEN, OK
from .lib import InfinityConnection

# Offload/restore copy accounting. ``staging_copies`` counts extra
# host->host copies and must stay 0 on SHM puts.
copy_counters = {
    "d2h_copies": 0, "d2h_bytes": 0,          # device->host DMAs
    "h2d_copies": 0, "h2d_bytes": 0,          # host->device DMAs
    "staging_copies": 0, "staging_bytes": 0,  # extra host->host copies
}


def reset_copy_counters():
    for k in copy_counters:
        copy_counters[k] = 0


# Page-locked pool ranges: base address -> [size, references]. Several
# stores may share one connection's pools.
_pinned = {}
_pinned_lock = threading.Lock()


def _pin_range(ptr, size):
    with _pinned_lock:
        ent = _pinned.get(ptr)
        if ent is not None:
            ent[1] += 1
            return
        torch.cuda.check_error(
            torch.cuda.cudart().cudaHostRegister(ptr, size, 0)
        )
        _pinned[ptr] = [size, 1]


def _unpin_range(ptr):
    with _pinned_lock:
        ent = _pinned.get(ptr)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            del _pinned[ptr]
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostUnregister(ptr)
            )


def _wait_current_stream():
    """Block until the copies queued so far on the current stream are
    done (an event recorded behind them)."""
    done = torch.cuda.Event()
    done.record()
    done.synchronize()


def _as_bytes(t):
    """A contiguous tensor as a flat uint8 view (no copy)."""
    return t.reshape(-1).view(torch.uint8)


def _runs(blocks, page_bytes, skip_fake):
    """Group pages into runs whose blocks lie back to back in one pool:
    [(first page, pages, pool_idx, byte offset)]. With ``skip_fake``
    FAKE blocks (already stored by another writer) are left out."""
    idx = np.arange(len(blocks))
    if skip_fake:
        idx = idx[blocks["token"] != FAKE_TOKEN]
    if len(idx) == 0:
        return []
    pool = blocks["pool_idx"][idx].astype(np.int64)
    off = blocks["offset"][idx].astype(np.int64)
    brk = np.ones(len(idx), dtype=bool)
    brk[1:] = ((idx[1:] != idx[:-1] + 1) | (pool[1:] != pool[:-1])
               | (off[1:] != off[:-1] + page_bytes))
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], len(idx))
    return [(int(idx[s]), int(e - s), int(pool[s]), int(off[s]))
            for s, e in zip(starts, ends)]


def _abort_uncommitted(conn, blocks):
    """Best-effort rollback of an allocate whose write failed: tokens
    left uncommitted would dedup-poison the keys for every client. A
    dead connection cannot send the abort, but then the server's
    dead-connection cleanup aborts them."""
    toks = blocks["token"][
        (blocks["status"] == OK) & (blocks["token"] != FAKE_TOKEN)
    ]
    if len(toks):
        try:
            conn.abort(np.asarray(toks, dtype=np.uint64))
        except Exception:
            pass


class CudaKVStore:
    """KV-page interface over an :class:`InfinityConnection`, with
    tensors on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, conn: InfinityConnection, device="cuda"):
        self.conn = conn
        self.device = resolve_device(device)
        self._registered = {}  # pool_idx -> base address pinned by us
        if self.device.type == "cuda" and conn.shm_connected:
            self.pin_pools()

    # -- pools -----------------------------------------------------------

    def _pool_count(self):
        return int(self.conn._lib.ist_pool_count(self.conn._h))

    def _pool_tensor(self, pool_idx):
        if pool_idx >= self._pool_count():
            self.conn.refresh_pools()  # the server auto-extended
        return torch.from_numpy(self.conn.pool_view(pool_idx))

    def pin_pools(self):
        """Page-lock every pool mapped so far (set-up: registering a
        pool costs about as long as copying it once). Pools added later
        by auto-extension are registered on first use."""
        self._register(range(self._pool_count()))

    def _register(self, pool_ids):
        """Page-lock the pools a CUDA copy is about to touch."""
        for p in sorted(set(pool_ids) - set(self._registered)):
            view = self._pool_tensor(p)
            ptr = view.data_ptr()
            _pin_range(ptr, view.numel())
            self._registered[p] = ptr

    def close(self):
        """Unregister the pool views this store page-locked. Call before
        the connection closes (its pools are unmapped then)."""
        regs, self._registered = self._registered, {}
        for ptr in regs.values():
            _unpin_range(ptr)

    # -- copies ------------------------------------------------------------

    def _copy_into_pool(self, src, blocks, page_bytes):
        """Device (or CPU) bytes -> their pool blocks, synchronized."""
        runs = _runs(blocks, page_bytes, skip_fake=True)
        cuda = src.is_cuda
        if cuda:
            self._register([r[2] for r in runs])
        for first, count, pool_idx, off in runs:
            nbytes = count * page_bytes
            dst = self._pool_tensor(pool_idx)[off:off + nbytes]
            dst.copy_(src[first * page_bytes:first * page_bytes + nbytes],
                      non_blocking=cuda)
            if cuda:
                copy_counters["d2h_copies"] += 1
                copy_counters["d2h_bytes"] += nbytes
        if cuda:
            _wait_current_stream()

    def _copy_from_pool(self, dst, blocks, page_bytes):
        """Pool blocks -> device (or CPU) bytes, synchronized."""
        runs = _runs(blocks, page_bytes, skip_fake=False)
        cuda = dst.is_cuda
        if cuda:
            self._register([r[2] for r in runs])
        for first, count, pool_idx, off in runs:
            nbytes = count * page_bytes
            src = self._pool_tensor(pool_idx)[off:off + nbytes]
            dst[first * page_bytes:first * page_bytes + nbytes].copy_(
                src, non_blocking=cuda)
            if cuda:
                copy_counters["h2d_copies"] += 1
                copy_counters["h2d_bytes"] += nbytes
        if cuda:
            _wait_current_stream()

    def _host_bytes(self, src):
        """``src`` bytes in host memory for the STREAM path: a CUDA
        tensor lands in a fresh pinned buffer (one D2H), a CPU tensor is
        used in place."""
        if not src.is_cuda:
            return src
        host = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(src, non_blocking=True)
        torch.cuda.current_stream(src.device).synchronize()
        copy_counters["d2h_copies"] += 1
        copy_counters["d2h_bytes"] += src.numel()
        return host

    def _write_pages(self, src, blocks, page_bytes):
        """Write n pages of ``src`` (flat uint8) into allocated
        ``blocks``: straight into the pool and commit (SHM), or a
        pipelined ``write_cache`` (STREAM, visible after ``sync``)."""
        n = len(blocks)
        if self.conn.shm_connected:
            self._copy_into_pool(src, blocks, page_bytes)
            self.conn.commit(blocks["token"][blocks["status"] == OK])
            return
        self.conn.write_cache(self._host_bytes(src).numpy(),
                              [i * page_bytes for i in range(n)],
                              page_bytes, blocks)

    # -- generic arrays --------------------------------------------------

    def put_arrays(self, items, sync=False):
        """Store [(key, tensor)] pairs, one page each. Callers may
        mutate their tensors as soon as this returns."""
        if not items:
            return
        by_size = {}
        for k, a in items:
            src = _as_bytes(a.contiguous())
            if not self.conn.shm_connected and not src.is_cuda and not sync:
                # STREAM writes are pipelined: detach from the caller.
                src = src.clone()
                copy_counters["staging_copies"] += 1
                copy_counters["staging_bytes"] += src.numel()
            by_size.setdefault(src.numel(), []).append((k, src))
        for nbytes, group in by_size.items():
            keys = [k for k, _ in group]
            blocks = self.conn.allocate(keys, nbytes)
            for i, (k, src) in enumerate(group):
                try:
                    self._write_pages(src, blocks[i:i + 1], nbytes)
                except BaseException:
                    _abort_uncommitted(self.conn, blocks[i:])
                    raise
        if sync:
            self.conn.sync()

    def get_array(self, key, shape, dtype, device=None):
        """Fetch one tensor of ``shape``/``dtype`` onto ``device``."""
        return self.get_kv_pages([key], tuple(shape), dtype, device)[0]

    # -- paged KV --------------------------------------------------------

    def put_kv_pages(self, keys, pages, sync=False):
        """Store pages [n_pages, ...] (page i under keys[i]) with one
        allocate for the batch. SHM: written and committed when this
        returns. STREAM: pipelined; a CPU input must not change until
        ``conn.sync()``."""
        n = pages.shape[0]
        if n != len(keys):
            raise ValueError("len(keys) must equal pages.shape[0]")
        src = _as_bytes(pages.contiguous())
        page_bytes = src.numel() // max(n, 1)
        blocks = self.conn.allocate(keys, page_bytes)
        try:
            self._write_pages(src, blocks, page_bytes)
        except BaseException:
            _abort_uncommitted(self.conn, blocks)
            raise
        if sync:
            self.conn.sync()
        return blocks

    def _read_into(self, out_bytes, keys, page_bytes):
        if self.conn.shm_connected:
            lease, blocks = self.conn.pin(keys)
            try:
                # Synchronized inside: the copy is done before release.
                self._copy_from_pool(out_bytes, blocks, page_bytes)
            finally:
                self.conn.release(lease)
            return
        cuda = out_bytes.is_cuda
        buf = (torch.empty(out_bytes.numel(), dtype=torch.uint8,
                           pin_memory=True) if cuda else out_bytes)
        self.conn.read_cache(
            buf.numpy(), [(k, i * page_bytes) for i, k in enumerate(keys)],
            page_bytes,
        )
        self.conn.sync()
        if cuda:
            out_bytes.copy_(buf, non_blocking=True)
            torch.cuda.current_stream(out_bytes.device).synchronize()
            copy_counters["h2d_copies"] += 1
            copy_counters["h2d_bytes"] += buf.numel()

    def get_kv_pages(self, keys, page_shape, dtype, device=None):
        """Fetch pages for ``keys`` into one new tensor
        [len(keys), *page_shape] on ``device`` (default: the store's)."""
        device = self.device if device is None else resolve_device(device)
        out = torch.empty((len(keys), *page_shape), dtype=dtype,
                          device=device)
        if len(keys):
            page_bytes = out[0].numel() * out.element_size()
            self._read_into(_as_bytes(out), keys, page_bytes)
        return out

    def get_kv_pages_host(self, keys, page_shape, dtype):
        """Fetch pages into a new CPU tensor (own bytes)."""
        return self.get_kv_pages(keys, page_shape, dtype, device="cpu")

    def prefetch(self, keys):
        """Advisory promotion kick for pages about to be read. Returns
        True when issued; never raises."""
        fn = getattr(self.conn, "prefetch", None)
        if fn is None or not keys:
            return False
        try:
            fn(keys)
            return True
        except Exception:
            return False

    def cached_prefix_len(self, keys):
        """How many leading pages of ``keys`` are cached (0 if none).
        Connection failures propagate."""
        return self.conn._match_last_index_raw(keys) + 1


class LayerStreamer:
    """Overlap per-layer KV upload with compute.

    ``submit_pages(keys, pages)`` records an event on the current stream
    and queues the layer for an upload thread. For a CUDA tensor the
    device->host copy runs on a side stream behind that event, one event
    per layer marking its end: on SHM straight into the allocated pool
    blocks (then commit), on STREAM into a pinned buffer that the
    connection's IO thread sends. Compute never waits on the copy or the
    store. ``finish`` barriers every queued layer and raises if one
    failed. Keep the tensors unchanged until ``finish``.
    """

    _STOP = object()

    def __init__(self, conn: InfinityConnection):
        self.conn = conn
        # Only its copy helpers are used: the submitted tensors' device
        # picks the path, so the helper store's own device is moot.
        self._store = CudaKVStore(conn, device="cpu")
        if torch.cuda.is_available() and conn.shm_connected:
            self._store.pin_pools()  # set-up, ahead of the first layer
        self._side = None
        self._q = queue.Queue()
        self._errors = []
        self._thread = threading.Thread(
            target=self._upload_loop, name="layer-streamer", daemon=True
        )
        self._thread.start()

    def submit(self, key, tensor):
        """Queue one tensor (one page) for upload under ``key``."""
        self.submit_pages([key], tensor.reshape(1, -1))

    def submit_pages(self, keys, pages):
        """Queue [n_pages, ...]; page i goes under keys[i]."""
        if len(keys) != pages.shape[0]:
            raise ValueError("len(keys) must equal pages.shape[0]")
        if len(keys) == 0:
            return
        src = _as_bytes(pages.contiguous())
        ready = host = None
        if src.is_cuda:
            if self._side is None:
                self._side = torch.cuda.Stream(src.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(src.device))
            if not self.conn.shm_connected:
                # STREAM: start the D2H now into pinned memory.
                host = torch.empty(src.numel(), dtype=torch.uint8,
                                   pin_memory=True)
                with torch.cuda.stream(self._side):
                    self._side.wait_event(ready)
                    host.copy_(src, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._side)
                copy_counters["d2h_copies"] += 1
                copy_counters["d2h_bytes"] += src.numel()
        self._q.put((list(keys), src, ready, host))

    def _upload_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is LayerStreamer._STOP:
                    return
                self._upload(*item)
            finally:
                self._q.task_done()

    def _upload(self, keys, src, ready, host):
        page_bytes = src.numel() // len(keys)
        try:
            blocks = self.conn.allocate(keys, page_bytes)
        except Exception as e:
            self._errors.append((keys[0], e))
            return
        try:
            if self.conn.shm_connected:
                if src.is_cuda:
                    with torch.cuda.device(src.device), \
                            torch.cuda.stream(self._side):
                        self._side.wait_event(ready)
                        self._store._copy_into_pool(src, blocks, page_bytes)
                else:
                    self._store._copy_into_pool(src, blocks, page_bytes)
                self.conn.commit(blocks["token"][blocks["status"] == OK])
                return
            if ready is not None:
                ready.synchronize()  # the layer's D2H has landed
            data = (host if host is not None else src).numpy()
            self.conn._write_async_native(
                data, [i * page_bytes for i in range(len(keys))],
                page_bytes, blocks, _ErrSink(self._errors, keys[0]),
            )
        except Exception as e:
            _abort_uncommitted(self.conn, blocks)
            self._errors.append((keys[0], e))

    def finish(self):
        """Barrier: every submitted layer written and committed; raises
        if any failed. The error list is always drained."""
        self._q.join()
        sync_exc = None
        try:
            self.conn.sync()
        except Exception as e:
            sync_exc = e
        errs, self._errors = self._errors, []
        if errs:
            raise RuntimeError(f"layer uploads failed: {errs}") from sync_exc
        if sync_exc is not None:
            raise sync_exc

    def close(self):
        """Stop the upload thread (queued layers drain first) and
        unregister the pools it page-locked."""
        self._q.put(LayerStreamer._STOP)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError(
                "layer-streamer upload thread did not stop; the store "
                "connection must not be destroyed while it is running"
            )
        self._store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ErrSink:
    def __init__(self, errors, key):
        self.errors = errors
        self.key = key

    def __call__(self, status):
        if status != OK:
            self.errors.append((self.key, status))
