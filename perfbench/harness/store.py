"""The store under test and the benchmark's timers around it.

One in-process ``InfiniStoreServer`` with ``enable_shm=False`` (its pool
is anonymous memory, nothing in ``/dev/shm``), no bundle and no spill
file, reached over loopback by one ``InfinityConnection`` of type
STREAM, under the engine's ``CudaKVStore``. The engine binds
``store.get_kv_pages`` and ``store.put_kv_pages`` when it is built and
calls ``store.conn.sync()`` after each offload, so the engine is handed
:class:`StoreSpy`, which times and counts those three calls.
"""

import time

from torch.profiler import record_function


class _Timed:
    """Wrap ``fn`` so each call appends (start, end, bytes) on the host
    clock to the list ``calls``, under a profiler range named ``name``;
    ``nbytes(args, result)`` counts its bytes."""

    def __init__(self, fn, calls, name, nbytes=None):
        self.fn, self.calls, self.name, self.nbytes = fn, calls, name, nbytes

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        with record_function(self.name):
            out = self.fn(*args, **kw)
        t1 = time.perf_counter()
        self.calls.append((t0, t1, self.nbytes(args, out) if self.nbytes
                           else 0))
        return out


class _ConnSpy:
    """The connection as the engine sees it: ``sync`` timed."""

    def __init__(self, conn, calls):
        self._conn = conn
        self.sync = _Timed(conn.sync, calls, "store.sync")

    def __getattr__(self, name):
        return getattr(self._conn, name)


class StoreSpy:
    """A ``CudaKVStore`` whose page reads, page writes and syncs are
    timed (``gets``, ``puts``, ``syncs``: lists of (start, end, bytes));
    everything else passes through."""

    def __init__(self, store):
        self._store = store
        self.gets, self.puts, self.syncs = [], [], []
        self.get_kv_pages = _Timed(
            store.get_kv_pages, self.gets, "store.get",
            lambda a, out: out.numel() * out.element_size())
        self.put_kv_pages = _Timed(
            store.put_kv_pages, self.puts, "store.put",
            lambda a, out: a[1].numel() * a[1].element_size())
        self.conn = _ConnSpy(store.conn, self.syncs)

    def __getattr__(self, name):
        return getattr(self._store, name)


class Store:
    """Server, connection and ``CudaKVStore`` of one run; ``close`` stops
    them in reverse order."""

    def __init__(self, device, page_bytes, prealloc_gib, extend_gib=1):
        from infinistore_tpu_torch import (TYPE_STREAM, ClientConfig,
                                           InfiniStoreServer,
                                           InfinityConnection, ServerConfig)
        from infinistore_tpu_torch.cuda import CudaKVStore

        self.server = InfiniStoreServer(ServerConfig(
            host="127.0.0.1", service_port=0, manage_port=0,
            prealloc_size=prealloc_gib, extend_size=extend_gib,
            auto_increase=True, minimal_allocate_size=page_bytes // 1024,
            enable_shm=False, bundle_dir="", ssd_path="", ssd_size=0))
        port = self.server.start()
        self.conn = None
        self.kv = None
        try:
            self.conn = InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=port,
                connection_type=TYPE_STREAM))
            self.conn.connect()
            self.kv = CudaKVStore(self.conn, device)
        except BaseException:
            self.close()
            raise

    def close(self):
        if self.kv is not None:
            self.kv.close()
            self.kv = None
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        if self.server is not None:
            self.server.stop()
            self.server = None
