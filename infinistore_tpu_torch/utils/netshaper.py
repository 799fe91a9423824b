"""Userspace latency/bandwidth-shaping TCP relay (the port's copy of
``infinistore_tpu/utils/netshaper.py``).

The reference validates its remote path against real verbs hardware
(reference: infinistore/test_infinistore.py:65-70 runs RDMA loopback on
an mlx5 NIC), so its flow-control constants are exercised at a real
link's bandwidth-delay product. This host has no real DCN, so the relay
stands in: an accept→connect proxy that injects a configurable one-way
delay (RTT/2 per direction) and enforces a bandwidth cap with a pacing
sender, giving the STREAM client's byte window and overflow queue
(native/src/client.cc, DEFAULT_WINDOW_BYTES in common.h) a real BDP to
fill. A windowed pipeline that sustains >=~0.8 of the shaped link proves
the flow control works where it matters; a stop-and-wait design would
collapse to payload/(RTT) instead.

Emulation model per direction (like a fixed-rate link with a FIFO
router buffer):
  - reader thread drains the source socket eagerly into a bounded byte
    queue (the "router buffer"; reader blocks when full, which is the
    backpressure a real bottleneck queue applies);
  - pacer thread releases each chunk no earlier than arrival + delay,
    and no faster than the bandwidth cap (virtual-clock pacing:
    send_i starts at max(arrival_i + delay, prev_send_end), ends
    len_i/bandwidth later).
Both directions are shaped independently, so a request/response pair
pays the full RTT and bulk data pays the cap — the two properties a
BDP test needs.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque

_CHUNK = 64 << 10


class _Pipe:
    """One shaped direction: src socket -> bounded queue -> dst socket."""

    def __init__(self, src, dst, delay_s, bps, buf_bytes):
        self.src, self.dst = src, dst
        self.delay_s, self.bps = delay_s, bps
        self.buf_bytes = buf_bytes
        self.q = deque()  # (arrival_time, bytes)
        self.q_bytes = 0
        self.eof = False    # reader finished (src closed)
        self.dead = False   # pacer finished (dst closed / error)
        self.cv = threading.Condition()
        self.threads = [
            threading.Thread(target=self._read, daemon=True),
            threading.Thread(target=self._pace, daemon=True),
        ]

    def start(self):
        for t in self.threads:
            t.start()

    def _read(self):
        try:
            while True:
                data = self.src.recv(_CHUNK)
                if not data:
                    break
                with self.cv:
                    # A dead pacer drains nothing: waiting on a full
                    # queue would spin forever (and pin this thread +
                    # the src socket for the relay's lifetime) — bail.
                    while (self.q_bytes >= self.buf_bytes
                           and not self.dead):
                        self.cv.wait(1.0)
                    if self.dead:
                        break
                    self.q.append((time.perf_counter(), data))
                    self.q_bytes += len(data)
                    self.cv.notify_all()
        except OSError:
            pass
        finally:
            with self.cv:
                self.eof = True
                self.cv.notify_all()

    def _pace(self):
        next_send = 0.0
        try:
            while True:
                with self.cv:
                    while not self.q and not self.eof:
                        self.cv.wait(1.0)
                    if not self.q:
                        break
                    t_arr, data = self.q.popleft()
                    self.q_bytes -= len(data)
                    self.cv.notify_all()
                start = max(t_arr + self.delay_s, next_send)
                now = time.perf_counter()
                if start > now:
                    time.sleep(start - now)
                self.dst.sendall(data)
                next_send = start + (len(data) / self.bps if self.bps else 0)
        except OSError:
            pass
        finally:
            with self.cv:
                self.dead = True
                self.cv.notify_all()
            try:
                self.dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass


class ShapingRelay:
    """Accept→connect proxy shaping every relayed connection.

    Args:
      target_port: upstream server port (on 127.0.0.1).
      rtt_ms: round-trip time to inject (RTT/2 of one-way delay per
        direction).
      bandwidth_bps: per-direction byte rate cap; None = unshaped rate.
      buf_bytes: per-direction relay buffer (router queue) bound.
    """

    def __init__(self, target_port, rtt_ms=4.0, bandwidth_bps=None,
                 target_host="127.0.0.1", buf_bytes=16 << 20):
        self.target = (target_host, target_port)
        self.delay_s = rtt_ms / 2e3
        self.bps = bandwidth_bps
        self.buf_bytes = buf_bytes
        self._lsock = None
        self._accept_thread = None
        self._conns = []
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    def start(self) -> int:
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self._lsock.settimeout(0.5)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()
        return self._lsock.getsockname()[1]

    @property
    def port(self) -> int:
        return self._lsock.getsockname()[1]

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                cli, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                up = socket.create_connection(self.target)
            except OSError:
                cli.close()
                continue
            for s in (cli, up):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Register BEFORE starting the pipes, under the lock stop()
            # iterates with: a connection accepted concurrently with
            # stop() must either be closed here or be visible to
            # stop()'s close loop — never survive it.
            with self._conns_lock:
                if self._stop.is_set():
                    cli.close()
                    up.close()
                    continue
                self._conns.append((cli, up))
            pipes = (
                _Pipe(cli, up, self.delay_s, self.bps, self.buf_bytes),
                _Pipe(up, cli, self.delay_s, self.bps, self.buf_bytes),
            )
            for p in pipes:
                p.start()

    def stop(self):
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for cli, up in conns:
            for s in (cli, up):
                try:
                    s.close()
                except OSError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(2.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
