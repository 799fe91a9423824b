"""Continuous-batching serving engine over the paged-KV store, in PyTorch.

The counterpart of ``infinistore_tpu/serving.py``, with the same names
(``ServingConfig``, ``Request``, ``ServingEngine`` and its methods,
``content_page_keys``, ``prompt_lookup_propose``) so each piece finds its
counterpart there. The loop the store exists for: probe the store for a
cached prefix, restore it into the device page pool, prefill only the
uncached tail, decode all slots in lockstep, offload finished pages.

- **Slot-based continuous batching**: a fixed batch of ``max_slots``
  sequences decodes in lockstep through ``decode_step``; requests are
  admitted into free slots as others finish.
- **Paged device pool**: KV lives in pages [n_layers, total_pages, page,
  n_kv, hd] on the engine's device, with a host free list and per-slot
  page tables; page 0 is the scratch page inactive rows write into.
- **Prefix-cache hits**: page keys are content-addressed (a hash chain
  over token ids, byte-identical to the JAX engine's for the same
  tokens, config and ``model_id``), so a prompt that extends a cached
  prefix restores those pages and prefills only the rest.
- **Offload on finish**, **windowed release** and **preemption through
  the store**: full pages go to the store before their pool pages are
  reused; a preempted sequence resumes through the prefix-hit path.
  While the engine has other work, a finish or a windowed release
  stages its pages to host memory and hands them to the engine's
  write-behind thread, which puts them and waits for the ack; the step
  goes on at once (at most ``OFFLOADS_IN_FLIGHT`` wait for their ack).
- **Speculative decoding** (``spec_k``), **chunked prefill**
  (``prefill_chunk``) and **multi-step bursts** (``host_steps``), with
  seeded per-request sampling on the host (numpy), as in the JAX engine.
- **Spans and counters** (``ServingEngine.stats``, served at the HTTP
  front end's ``/stats``): admission (``engine.admit`` with its children
  ``engine.probe``, ``engine.restore``, ``engine.prefill``), decode
  (``engine.decode``: ``engine.decode.dispatch`` queues the step's
  kernels, ``engine.decode.wait`` waits for its tokens) and offload
  (``engine.offload``, the step's own part, counted as ``offload_step``:
  ``engine.offload.gather``, then either ``engine.offload.write`` or,
  behind the step, the staging and ``engine.offload.room_wait``;
  ``engine.offload.write``, on the step's thread or on the write-behind
  thread, holds the store's put spans and each run's
  ``engine.offload.ack``) each add ``<key>_ns`` / ``<key>_n``
  (:class:`~infinistore_tpu_torch.utils.profiling.Span`; under a torch
  profiler also ranges with the request id); the store's own span
  counters are folded in after each store call; ``queue_wait_*``,
  ``step_*``, ``offload_bytes``, ``restore_bytes``, ``offload_ns`` /
  ``offload_n`` (one offload's own work, wherever it ran),
  ``offload_behind_n`` (offloads handed to the write-behind thread) and
  ``decode_graph_captures`` / ``decode_graph_replays`` are counters. A
  model family that times its own layers (``models.afmoe``: ``moe.route``
  and ``moe.experts``) adds its spans to the same ``stats``.
- **The decode step as one CUDA graph**: on a card, with no mesh, and
  for a model family that offers one (``llama.DecodeGraph``; the MoE's
  routed step stays eager), every single-token decode step, alone or in
  a burst, replays the whole forward as one graph captured at the first
  step: ``engine.decode.dispatch`` then holds the graph's key check, the
  input copies, the replay and the argmax, and ``engine.decode.wait``
  the card's step.
- **Quantized wire (opt-in)**: ``ServingConfig(quantized_store=True)``
  moves pages to and from the store int8-packed (``ops/kv_quant.py``,
  quantized and packed on the device): about half the offload/restore
  bytes and store capacity, at ~0.4% KV error. Restored pages are
  dequantized into the engine's bf16/f32 pool, as in the JAX engine, and
  decode stays on the bf16/f32 kernel. The key namespace ends in ``q8``
  instead of the dtype, as the JAX engine's does: int8 and raw pages
  never cross-hit, and the two packages' engines share int8 pages.

Where it differs from the JAX engine, and why:

- The pools are updated in place (``index_copy_``, in-place scatters)
  where the JAX engine donates buffers to its jitted programs.
- No fixed-arity padding: the JAX engine pads page-id lists to
  ``max_pages_per_seq`` and prompts to page multiples only to keep XLA's
  compile cache small. Here only the real page ids are written and only
  the real tokens prefilled; every position a slot attends holds the
  same contents. Likewise a multi-token step is as wide as its longest
  row, not the pinned ``prefill_chunk``: real rows get the same results.
- A multi-step burst is a Python loop of ``decode_step`` with the tokens
  kept on the device and one device-to-host copy per burst (the JAX
  engine fuses it with ``lax.scan``).
- A mesh (``mesh=``): the JAX engine runs unchanged on a sharded tree
  and XLA inserts the collectives. Here every rank of the mesh's inner
  dim runs an engine over its shard of the weights, and the models make
  the collectives explicit. On a (dp, tp) mesh (tensor parallelism:
  dense, int8 or MoE trees) the pool holds the rank's kv heads; on a
  (dp, ep) mesh (expert parallelism, the MoE family) every rank holds
  every kv head and its experts. The logits are the same on every rank,
  so every rank schedules and samples alike; each store call's outcome
  is agreed over the inner dim before it steers anything. The store
  sees whole pages under the single-device keys: under tp heads are
  gathered before rank 0 puts and each rank keeps its heads' slice of a
  restored page; under ep rank 0 puts its own pages.
"""

import contextlib
import hashlib
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ._device import resolve_device
from .lib import InfiniStoreKeyNotFound
from .models import llama, moe
from .utils.profiling import Span

# Offloads handed to the write-behind thread and not yet acknowledged, at
# most. Each holds its pages in pinned host memory (a 4096-token request
# of Mistral-7B: 512 MiB); a step that would hand over one more first
# waits for the oldest. Chosen from a measurement on one H100 (PERF.md).
OFFLOADS_IN_FLIGHT = 3
# The write-behind thread puts an offload in runs of whole pages (every
# layer's k and v) of about this many bytes, each with its ack: the
# store's connection serves one message at a time, so an admission's
# probe waits behind one run, not behind the whole offload; and a probe
# finds a page only once all its layers are in.
OFFLOAD_RUN_BYTES = 16 << 20


def content_page_digests(tokens, page_size, n_pages, namespace=""):
    """Per-page content digests, vLLM-style: digest i is the hash CHAIN
    over ``namespace`` plus all tokens up to the end of page i, so two
    requests share exactly the pages whose full token prefix (and model
    namespace) is identical, and a divergent prompt can never restore
    another sequence's KV. ``namespace`` must identify everything that
    shapes the bytes (see ``ServingEngine._ns``).

    The digest is layer/kind-independent: compute it once per sequence
    and format the per-(layer, kind) keys with :func:`content_page_keys`."""
    digests = []
    h = hashlib.sha256(namespace.encode())
    _extend_digest_chain(
        h, digests,
        lambda i: tokens[i * page_size:(i + 1) * page_size], n_pages,
    )
    return digests


def _extend_digest_chain(h, digests, get_chunk, n_pages):
    """Append pages [len(digests), n_pages) to a digest chain in place:
    the one definition of the per-page hash step (int32 bytes, 32 hex
    characters), shared by :func:`content_page_digests` and the engine's
    per-slot incremental chain so the two can never drift.
    ``get_chunk(i)`` returns page i's token slice."""
    for i in range(len(digests), n_pages):
        chunk = np.asarray(get_chunk(i), dtype=np.int32)
        h.update(chunk.tobytes())
        digests.append(h.hexdigest()[:32])


def content_page_keys(tokens, page_size, n_pages, layer, kind,
                      namespace="", digests=None):
    """Store keys for one (layer, kind) from content digests (computed
    here unless the caller passes precomputed ``digests``)."""
    if digests is None:
        digests = content_page_digests(tokens, page_size, n_pages,
                                       namespace)
    return [f"cp/{d}/L{layer}/{kind}" for d in digests]


@dataclass(frozen=True)
class ServingConfig:
    max_slots: int = 4           # concurrent sequences (the static batch)
    total_pages: int = 64        # device pool capacity (page 0 is scratch)
    max_pages_per_seq: int = 16  # page-table width
    eos_id: int = -1             # -1: no EOS, run to max_new_tokens
    model_id: str = "default"    # distinct per checkpoint: part of the
    #                              store-key namespace; engines with
    #                              different weights sharing one store
    #                              MUST use different model_ids
    quantized_store: bool = False  # int8 pages on the store wire: about
    #                                half the restore/offload bytes and
    #                                store capacity at ~0.4% KV error
    #                                (ops/kv_quant.py); keys are
    #                                namespaced apart from raw pages
    spec_k: int = 0              # speculative decoding: propose up to k
    #                              tokens per step and verify them in ONE
    #                              multi-token pass (0 = off). Greedy
    #                              requests use argmax-prefix acceptance,
    #                              sampled ones rejection sampling
    host_steps: int = 1          # multi-step bursts: when every active
    #                              slot is greedy and mid-decode, run up
    #                              to this many decode steps with one
    #                              device-to-host copy per burst (powers
    #                              of 2, as in the JAX engine)
    prefill_chunk: int = 0       # chunked prefill (0 = off): admission
    #                              consumes the prompt <= chunk tokens
    #                              per engine step in a MIXED batch with
    #                              decoding slots


@dataclass
class Request:
    request_id: str
    prompt: list              # token ids
    max_new_tokens: int = 16
    cache: bool = True        # use the store for prefix reuse + offload
    temperature: float = 0.0  # 0 = greedy; > 0 samples softmax(z/T)
    top_k: int = 0            # 0 = full distribution; else top-k filter
    seed: int = 0             # per-request sampling stream (numpy; the
    #                           RNG travels with the request's _Work, so
    #                           the stream survives preemption)
    on_token: object = None   # optional callable(request_id, token),
    #                           fired once per generated token as it is
    #                           produced (across preemptions too; a
    #                           mid-draft EOS emits only the kept tokens)


@dataclass
class _Work:
    """A request's schedulable state, surviving preemption: ``prompt``
    grows by the tokens generated before each swap-out, ``done``
    accumulates the request's output across incarnations, and ``rng``
    carries the sampling stream (one draw per token on the
    non-speculative paths; rejection sampling draws a variable number)."""
    req: Request
    prompt: list
    done: list = field(default_factory=list)
    rng: object = None
    probe: tuple = None   # cached (hit, digests) from _probe_hit: a
    #                       queued request retries admission every step
    #                       under pool pressure and must not re-hash and
    #                       re-probe each time (reset when prompt changes)
    queued_ns: int = 0    # perf_counter_ns() when it (re-)entered the queue

    def __post_init__(self):
        if self.req.temperature > 0 and self.rng is None:
            self.rng = np.random.default_rng(self.req.seed)


class _AdmitPagesRefunded(Exception):
    """Admission already returned its pages to the pool and the request
    should simply stay queued (not an error)."""


@dataclass
class _Slot:
    work: _Work
    page_ids: list            # pool pages owned, in sequence order
    seq_len: int              # tokens whose KV is in pages
    cached_pages: int = 0     # pages restored from the store at admission
    released: int = 0         # leading pages returned to the pool (below
    #                           the sliding-window floor)
    digests: list = field(default_factory=list)  # content-digest chain,
    digest_h: object = None   # + its hash state, extended incrementally
    generated: list = field(default_factory=list)
    pending: list = field(default_factory=list)  # prompt tokens not yet
    #                                              prefilled (chunked)

    def total_generated(self):
        return len(self.work.done) + len(self.generated)


def prompt_lookup_propose(context, k, ngram=2):
    """Draft-model-free proposer (prompt lookup / n-gram speculation):
    find the most recent earlier occurrence of the context's last
    ``ngram`` tokens and propose the k tokens that followed it; [] when
    the pattern has no earlier occurrence."""
    n = len(context)
    if n < ngram + 1:
        return []
    tail = context[n - ngram:]
    for start in range(n - ngram - 1, -1, -1):
        if context[start:start + ngram] == tail:
            return list(context[start + ngram:start + ngram + k])
    return []


class _LazyHost:
    """Device tensor -> host numpy, copied at most once and only if read
    (sampling slots need whole logits rows; greedy slots never pay)."""

    def __init__(self, arr):
        self._arr = arr
        self._host = None

    def __call__(self):
        if self._host is None:
            self._host = self._arr.cpu().numpy()
        return self._host


@torch.no_grad()
def _admit_fused(params, cfg, tokens, model=llama, **kw):
    """Cold admission: prefill ``tokens`` [1, s] and page its KV out
    (without grad, whether or not the leaves require it). Returns (the
    last position's logits row [vocab] float32, k and v pages [L, n,
    page, kv, hd], the tail page zero-padded)."""
    logits, kvs = model.prefill(params, cfg, tokens, **kw)
    return (logits[0, -1],) + _stack_pages(cfg, kvs)


def _stack_pages(cfg, kvs):
    """Per-layer (k, v) [1, s, kv, hd] -> k and v pages [L, n, page, kv,
    hd] (the tail page zero-padded)."""
    k = torch.stack([k[0] for k, _ in kvs])
    v = torch.stack([v[0] for _, v in kvs])
    return llama.kv_to_pages(cfg, k, v)


def _decode_graph(model, device, mesh_kw, stats):
    """The ``model.DecodeGraph`` an engine passes to every single-token
    decode step (``decode_step(..., graph=)``), or None where the engine
    cannot hold one: off the card, under a mesh (``mesh_kw``, the model
    calls' tp / ep argument), or for a model family whose decode step
    takes no graph (the MoE's: its routed FFN stays eager). The graph
    adds its capture and replay counts to ``stats``."""
    graph_cls = getattr(model, "DecodeGraph", None)
    if graph_cls is None or device.type != "cuda" or mesh_kw:
        return None
    return graph_cls(stats)


def _decode_fused(params, cfg, token, seq_lens, k_pages, v_pages, rows,
                  model=llama, **kw):
    """One decode step with the pools updated in place: model forward +
    device argmax + seq_lens advance. Returns (logits, next tokens,
    next lens); with ``graph=`` in ``kw`` the logits are the graph's
    static output, valid until the next step replays it, so the caller
    reads them (argmax here, a sampled row through _LazyHost) before
    then."""
    logits, _, _ = model.decode_step(params, cfg, token, seq_lens, k_pages,
                                     v_pages, rows, **kw)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    # Advance only live rows: inactive slots (lens == 0) stay at 0
    # across steady-state reuse.
    return logits, nxt, seq_lens + (seq_lens > 0).to(seq_lens.dtype)


def _decode_scan(params, cfg, token, seq_lens, k_pages, v_pages, rows,
                 n_steps, model=llama, **kw):
    """``n_steps`` greedy decode steps with the tokens kept on the
    device: the same tokens as n_steps single fused steps (each is one
    ``decode_step``). Returns (tokens [batch, n_steps], next lens)."""
    toks = []
    for _ in range(n_steps):
        _, token, seq_lens = _decode_fused(params, cfg, token, seq_lens,
                                           k_pages, v_pages, rows,
                                           model=model, **kw)
        toks.append(token)
    return torch.stack(toks, dim=1), seq_lens


# The weights checksum's modulus (a prime): sums of integers taken
# modulo it do not depend on their order.
_CHECKSUM_P = 2**31 - 1
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def weights_fingerprint(params):
    """Cheap checkpoint identity for the store-key namespace: sha256
    over every leaf's (shape, dtype) plus a position-weighted checksum
    per leaf (position weights, so two checkpoints that are element
    permutations of each other differ; see :func:`_checksum`). The
    checksum is an integer sum over the elements' bits, which no
    summation order changes, so it is the same on the CPU and on the
    card, and a tensor-parallel engine's shards (the DTensors of
    ``parallel.mesh.shard_params``, every leaf one) give the whole
    tree's fingerprint: each rank sums its blocks at their offsets in
    the whole leaf and the sums are added over the mesh (every rank of
    the mesh calls this). The JAX engine's fingerprint is another
    function, so the same checkpoint fingerprints differently in the two
    packages: that is a cache miss, never a cross-hit."""
    leaves = llama.param_leaves(params)
    sharded = [isinstance(x, DTensor) for x in leaves]
    if any(sharded) and not all(sharded):
        raise ValueError("a tree of DTensors and plain tensors")
    h = hashlib.sha256()
    sums = []
    for leaf in leaves:
        dtype = str(leaf.dtype).replace("torch.", "")
        h.update(str((tuple(leaf.shape), dtype)).encode())
        if isinstance(leaf, DTensor):
            from .parallel.mesh import block_of
            block, offsets, counts = block_of(leaf)
            sums.append(_checksum(block, leaf.shape, offsets) if counts
                        else torch.zeros((), dtype=torch.int64,
                                         device=block.device))
        else:
            sums.append(_checksum(leaf))
    sums = torch.stack(sums)
    if all(sharded) and leaves:
        import torch.distributed as dist
        mesh = leaves[0].device_mesh
        for i in range(mesh.ndim):
            dist.all_reduce(sums, group=mesh.get_group(i))
        sums %= _CHECKSUM_P
    h.update(sums.cpu().numpy().astype(np.int64).tobytes())
    return h.hexdigest()[:16]


def _checksum(x, shape=None, offsets=None):
    """Position-weighted sum, modulo a prime, of a tensor's element bits
    (read as integers of the element's width): the element at flat index
    i of the whole tensor weighs i % 251 + 1. ``x`` is the block of a
    whole tensor of ``shape`` at ``offsets`` (by default the whole
    tensor itself). Summed in slices of rows, so no leaf-sized weight
    tensor is built. Returns an int64 scalar on x's device."""
    x = x.reshape(1) if x.dim() == 0 else x
    shape = tuple(x.shape) if shape is None else tuple(shape) or (1,)
    offsets = offsets or (0,) * x.dim()
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]

    def pos(d, lo, n):  # dim d's term of the flat index, modulo 251
        return (torch.arange(lo, lo + n, device=x.device)
                * strides[d]) % 251

    tail = torch.zeros((), dtype=torch.int64, device=x.device)
    for d in range(1, x.dim()):
        tail = tail.unsqueeze(-1) + pos(d, offsets[d], x.shape[d])
    bits = x.contiguous().view(_BITS[x.element_size()])
    rows = max(1, (1 << 22) // max(1, tail.numel()))
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for r in range(0, x.shape[0], rows):
        part = bits[r:r + rows].to(torch.int64) % _CHECKSUM_P
        head = pos(0, offsets[0] + r, part.shape[0]).view(
            -1, *[1] * (x.dim() - 1))
        w = (head + tail) % 251 + 1
        total = (total + torch.sum(part * w)) % _CHECKSUM_P
    return total


class _Offload:
    """One offload: its keys and pages (page-major; host pages behind the
    step, the pool's gathered pages when it waits), the put to make and
    the keys a run puts, what the engine counts once it is back, and
    what came back (the step's and the write's time, the write's span
    increments, an error, or ``dropped`` after an earlier failure)."""

    __slots__ = ("keys", "host", "put", "run", "rid", "pages", "nbytes",
                 "step_ns", "work_ns", "stats", "err", "dropped")

    def __init__(self, put, rid, pages, nbytes):
        self.put, self.rid, self.pages, self.nbytes = put, rid, pages, nbytes
        self.keys = self.host = None
        self.run = self.step_ns = self.work_ns = 0
        self.stats, self.err, self.dropped = {}, None, False

    def write(self, store):
        """Write the offload in runs of ``run`` keys: ``put(keys, pages)``
        (allocate and send), then ``store.conn.sync()`` (the ack), then
        the next run. Records an error and the time on the job, the spans
        ``engine.offload.write`` and ``engine.offload.ack`` in its
        ``stats``, and lets go of the pages."""
        write = Span(self.stats, "engine.offload.write", "offload_write")
        ack = Span(self.stats, "engine.offload.ack", "offload_ack")
        t0 = time.perf_counter_ns()
        try:
            with write.of(rid=self.rid, pages=len(self.keys),
                          nbytes=self.nbytes):
                for a in range(0, len(self.keys), self.run):
                    self.put(self.keys[a:a + self.run],
                             self.host[a:a + self.run])
                    with ack:
                        store.conn.sync()
        except Exception as e:
            self.err = e
        finally:
            self.host = None
            self.work_ns = time.perf_counter_ns() - t0


class _WriteBehind:
    """An engine's write-behind thread. It writes the offloads handed to
    it in order (:meth:`_Offload.write`) and hands each back on ``done``.
    After a failure it writes nothing more: later offloads come back
    dropped. The thread runs while offloads wait and ends when none does;
    it is a daemon, and a connection closed under it ends it through the
    error. It writes nothing of the engine's: each offload carries its
    own span counts back, and the engine's thread adds them."""

    def __init__(self, store):
        self.store = store
        self.done = queue.SimpleQueue()
        self.in_flight = 0  # handed over and not taken back (engine's)
        self._jobs = deque()
        self._lock = threading.Lock()
        self._thread = None
        self._failed = False

    def submit(self, job):
        with self._lock:
            self._jobs.append(job)
            if self._thread is None:
                thread = threading.Thread(target=self._run, daemon=True,
                                          name="offload-write-behind")
                try:
                    thread.start()
                except BaseException:
                    self._jobs.pop()
                    raise
                self._thread = thread
        self.in_flight += 1

    def _run(self):
        while True:
            with self._lock:
                if not self._jobs:
                    self._thread = None
                    return
                job = self._jobs.popleft()
            try:
                if self._failed:
                    job.dropped, job.host = True, None
                else:
                    job.write(self.store)
                    self._failed = job.err is not None
            finally:
                self.done.put(job)


class ServingEngine:
    """Continuous-batching engine over the store for any model family of
    the port that exposes prefill / prefill_with_prefix / decode_step /
    verify_step over the shared KV page contract: ``model=llama`` with a
    ``LlamaConfig`` (the default), ``model=moe`` with a ``MoEConfig`` or
    ``model=afmoe`` with an ``AfmoeConfig`` (one device; its
    ``LayerSpans`` add the routed block's spans to ``stats``).
    The engine reads only the config fields both share; decode steps
    advance live rows only, so the MoE family's validity mask keeps idle
    slots out of expert capacity.

    ``store`` is a :class:`~infinistore_tpu_torch.cuda.CudaKVStore` on
    the engine's device (or None for store-less serving). The pools live
    on ``device`` (the card unless ``device="cpu"``); ``params`` must be
    there too. Decoding is greedy by default; per-request seeded
    temperature/top-k sampling via Request(temperature=..., top_k=...,
    seed=...).

    ``mesh``, a (dp, tp) DeviceMesh of ``parallel.mesh.make_mesh``, makes
    this engine one tp rank of a Megatron-sharded engine (either family,
    dense or int8 weights): ``params`` is then this rank's shard of the
    tree, the DTensors of ``parallel.mesh.shard_params(mesh, whole)``
    (no rank needs the whole tree once it is sharded), and the pool
    holds n_kv_heads / tp heads. A (dp, ep) DeviceMesh of
    ``moe.make_ep_mesh`` makes it one ep rank of an expert-parallel MoE
    engine: ``params`` from ``moe.shard_params(mesh, whole)``, the pool
    whole. Every rank of the inner dim must run the same requests in the
    same order, each with a store of its own or all without. At dp > 1
    the dp ranks are separate engines, each serving its own requests:
    nothing is summed over dp, so a MoE routes each engine's tokens
    alone, as one device would."""

    def __init__(self, params, cfg: "llama.LlamaConfig | moe.MoEConfig",
                 sconfig=None,
                 store=None, proposer=None, model=llama, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.sc = sconfig or ServingConfig()
        leaves = llama.param_leaves(params)
        for leaf in leaves:
            if isinstance(leaf, DTensor):
                leaf = leaf.to_local()
            if leaf.device != self.device:
                raise ValueError(
                    f"params lie on {leaf.device}, the engine on "
                    f"{self.device}")
        # The mesh's collectives (TensorParallel, or moe.ExpertParallel
        # on an ep mesh) and the model calls' argument naming them; the
        # dp ranks are replicas, each routing its own requests alone.
        self.par = None
        self._mkw = {}
        n_kv = cfg.n_kv_heads
        if mesh is not None:
            from .parallel.mesh import TensorParallel
            if tuple(mesh.mesh_dim_names or ()) == moe.EP_AXES:
                if not hasattr(cfg, "n_experts"):
                    raise ValueError("an ep mesh takes a MoE model "
                                     "(model=moe, a MoEConfig)")
                self.par = moe.ExpertParallel(mesh, replicas=True)
                self._mkw = {"ep": self.par}
                shard = "moe.shard_params(mesh, params)"
            else:
                self.par = TensorParallel(mesh, replicas=True)
                self.par.check(cfg)
                self._mkw = {"tp": self.par}
                n_kv //= self.par.tp
                shard = "parallel.mesh.shard_params(mesh, params)"
            if not all(isinstance(x, DTensor) and x.device_mesh == mesh
                       for x in leaves):
                raise ValueError(f"under a mesh, params are this rank's "
                                 f"shards: {shard}")
        self.cfg = cfg
        self.model = model
        self.store = store
        self.proposer = proposer if proposer is not None \
            else prompt_lookup_propose
        shape = (cfg.n_layers, self.sc.total_pages, cfg.page_size,
                 n_kv, cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        # Page 0 is the scratch page: inactive rows write their garbage
        # KV there; sequences never own it.
        self.free_pages = list(range(1, self.sc.total_pages))
        self.page_table = np.zeros(
            (self.sc.max_slots, self.sc.max_pages_per_seq), dtype=np.int32
        )
        self.slots = [None] * self.sc.max_slots
        self.queue = []
        self.outputs = {}
        self.stats = {
            "requests": 0, "prefix_hit_pages": 0, "restored_pages": 0,
            "prefill_tokens": 0, "decode_steps": 0, "decoded_tokens": 0,
            "offloaded_pages": 0, "preemptions": 0, "store_errors": 0,
            "restore_misses": 0, "spec_proposed": 0, "spec_accepted": 0,
            "chunk_steps": 0, "burst_steps": 0, "prefetched_pages": 0,
            "queue_wait_ns": 0, "queue_wait_n": 0, "step_ns": 0,
            "step_n": 0, "offload_bytes": 0, "restore_bytes": 0,
            "decode_graph_captures": 0, "decode_graph_replays": 0,
            "offload_ns": 0, "offload_n": 0, "offload_behind_n": 0,
            "offload_write_ns": 0, "offload_write_n": 0,
            "offload_ack_ns": 0, "offload_ack_n": 0,
        }
        # The single-token decode step replayed as one CUDA graph, where
        # this engine can hold one (_decode_graph).
        graph = _decode_graph(model, self.device, self._mkw, self.stats)
        self._gkw = {} if graph is None else {"graph": graph}
        # A family that times its own layers (models.afmoe's
        # LayerSpans) adds them to stats: every model call takes them.
        spans_cls = getattr(model, "LayerSpans", None)
        if spans_cls is not None:
            self._mkw = {**self._mkw, "spans": spans_cls(self.stats)}
        # Spans over stats (module docstring): <key>_ns / <key>_n each.
        self._sp_admit = Span(self.stats, "engine.admit", "admit")
        self._sp_probe = Span(self.stats, "engine.probe", "probe")
        self._sp_restore = Span(self.stats, "engine.restore", "restore")
        self._sp_prefill = Span(self.stats, "engine.prefill", "prefill")
        self._sp_decode = Span(self.stats, "engine.decode", "decode")
        self._sp_dispatch = Span(self.stats, "engine.decode.dispatch",
                                 "decode_dispatch")
        self._sp_wait = Span(self.stats, "engine.decode.wait", "decode_wait")
        self._sp_offload = Span(self.stats, "engine.offload",
                                "offload_step")
        self._sp_gather = Span(self.stats, "engine.offload.gather",
                               "offload_gather")
        self._sp_room = Span(self.stats, "engine.offload.room_wait",
                             "offload_room_wait")
        # The write-behind thread (_WriteBehind), made at its first use.
        self._behind = None
        # The store's own span counters (CudaKVStore.stats), folded into
        # stats after each store call: _store_seen holds what was folded.
        self._store_seen = dict(self._store_counts() or {})
        for k in self._store_seen:
            self.stats.setdefault(k, 0)
        self._page_bytes = cfg.kv_page_bytes()
        # The store accelerates, it is never a dependency: after the
        # first store failure the engine serves store-less.
        self._store_ok = True
        # Steady-state decode device cache: (key, token_dev, lens_dev,
        # rows_dev) left by the previous greedy step. While the active
        # set and page tables are what the device already holds, the
        # next step reuses them instead of uploading host state;
        # _pages_rev is bumped by every page-table change.
        self._steady = None
        self._pages_rev = 0
        # Everything that shapes page bytes goes into the key namespace.
        # With the default model_id and a store, a weights fingerprint
        # keeps two checkpoints of one geometry from cross-hitting.
        model_id = self.sc.model_id
        if store is not None and model_id == "default":
            model_id = f"wf{weights_fingerprint(params)}"
        if self.par is not None:
            params = self.par.local_tree(params)
        self.params = params
        wire = "q8" if self.sc.quantized_store else cfg.dtype
        self._ns = (
            f"{model_id}/p{cfg.page_size}/l{cfg.n_layers}"
            f"/kv{cfg.n_kv_heads}x{cfg.head_dim}/{wire}"
        )
        if store is not None and self.sc.quantized_store:
            self._get_pages = store.get_kv_pages_quantized
            self._put_pages = store.put_kv_pages_quantized
        elif store is not None:
            self._get_pages = store.get_kv_pages
            self._put_pages = store.put_kv_pages

    def _digests(self, tokens, n_pages):
        return content_page_digests(
            tokens, self.cfg.page_size, n_pages, namespace=self._ns
        )

    def _slot_digests(self, slot, n_pages):
        """content_page_digests, amortized per slot: the chain only
        appends as generation grows, so each page is hashed once per slot
        (windowed release offloads every page_size tokens)."""
        if len(slot.digests) >= n_pages:
            return slot.digests[:n_pages]
        if slot.digest_h is None:
            slot.digest_h = hashlib.sha256(self._ns.encode())
        ps = self.cfg.page_size
        prompt = slot.work.prompt
        n_p = len(prompt)

        def tok_slice(a, b):
            if b <= n_p:
                return prompt[a:b]
            if a >= n_p:
                return slot.generated[a - n_p:b - n_p]
            return list(prompt[a:]) + list(slot.generated[:b - n_p])

        _extend_digest_chain(
            slot.digest_h, slot.digests,
            lambda i: tok_slice(i * ps, (i + 1) * ps), n_pages,
        )
        return slot.digests[:n_pages]

    def _to_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- admission -----------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            # Admission always derives one token from the prompt's last
            # logits, so a 0-token budget is refused up front.
            raise ValueError("max_new_tokens must be >= 1")
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.cfg.page_size)
        if need > self.sc.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_seq "
                f"{self.sc.max_pages_per_seq}"
            )
        self.queue.append(_Work(req=req, prompt=list(req.prompt),
                                queued_ns=time.perf_counter_ns()))
        self.stats["requests"] += 1

    def _alloc(self, n):
        if len(self.free_pages) < n:
            return None
        ids, self.free_pages = self.free_pages[:n], self.free_pages[n:]
        return ids

    def _pool_write(self, ids, k_new, v_new):
        """Write [L, n, page, kv, hd] pages into the pool at ``ids``, IN
        PLACE."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        self.k_pages.index_copy_(1, idx, k_new.to(self.k_pages.dtype))
        self.v_pages.index_copy_(1, idx, v_new.to(self.v_pages.dtype))

    def _store_counts(self):
        """The store's span counters as they stand, or None."""
        counts = getattr(self.store, "stats", None)
        return counts if isinstance(counts, dict) else None

    def _fold_store_stats(self):
        """Add the store's span counters accrued since the last fold."""
        counts = self._store_counts()
        if counts is None:
            return
        seen = self._store_seen
        for k, v in counts.items():
            self.stats[k] = self.stats.get(k, 0) + v - seen.get(k, 0)
            seen[k] = v

    def _agree(self, value, largest=False):
        """A store call's outcome as every rank of the mesh's inner dim
        sees it (the smallest, or the largest, of the ranks'); the value
        itself without a mesh."""
        return value if self.par is None else self.par.agree(value, largest)

    def _store_failed(self, what, exc):
        """First store failure downgrades to store-less serving: the
        cache accelerates, it must never fail a request. Under a mesh,
        ``exc`` is None where another rank's call failed."""
        if exc is None:
            exc = RuntimeError("another rank's store call failed")
        self._store_ok = False
        self.stats["store_errors"] += 1
        logging.getLogger("infinistore_tpu_torch.serving").warning(
            "store %s failed (%s: %s) — continuing store-less",
            what, type(exc).__name__, exc,
        )

    def _probe_hit(self, work):
        """Page-granular prefix hit, capped so at least one prompt token
        remains to prefill (the engine needs its logits). Returns (hit,
        digests[:hit]) so the restore reuses the hash chain."""
        if self.store is None or not self._store_ok or not work.req.cache:
            return 0, []
        cap = (len(work.prompt) - 1) // self.cfg.page_size
        if cap == 0:
            return 0, []
        digests = self._digests(work.prompt, cap)
        keys = content_page_keys(work.prompt, self.cfg.page_size, cap, 0,
                                 "k", digests=digests)
        err = None
        try:
            with self._sp_probe.of(rid=work.req.request_id, pages=cap):
                hit = self.store.cached_prefix_len(keys)
        except Exception as e:
            hit, err = -1, e
        hit = self._agree(hit)
        if hit < 0:
            self._store_failed("probe", err)
            return 0, []
        hit = min(hit, cap)
        if hit > 0 and (self.par is None or self.par.leader):
            self._prefetch_chain(work.prompt, hit, digests[:hit])
        return hit, digests[:hit]

    def _prefetch_chain(self, prompt, hit, digests):
        """Fire-and-forget prefetch of every (layer, kind) page the
        restore will read, so the store promotes disk-resident pages
        ahead of the restore. Advisory: failures are swallowed."""
        fn = getattr(self.store, "prefetch", None)
        if fn is None:
            return
        cfg = self.cfg
        try:
            keys = []
            for li in range(cfg.n_layers):
                for kind in ("k", "v"):
                    keys.extend(content_page_keys(
                        prompt, cfg.page_size, hit, li, kind,
                        digests=digests,
                    ))
            if fn(keys):
                self.stats["prefetched_pages"] += len(keys)
        except Exception:
            pass

    def _admit(self, slot_idx, work):
        n_prompt = len(work.prompt)
        n_pages = -(-n_prompt // self.cfg.page_size)
        return self._do_admit(slot_idx, work, n_prompt, n_pages)

    def _do_admit(self, slot_idx, work, n_prompt, n_pages):
        cfg = self.cfg
        page = cfg.page_size
        window = cfg.window
        if work.probe is None:
            work.probe = self._probe_hit(work)
        hit, digests = work.probe
        store_chain = (self.store is not None and self._store_ok
                       and work.req.cache)
        if not store_chain and hit:
            # The cached probe can outlive the store (another slot's
            # failure between the probe and this retry): a dead store
            # chain means a cache miss, not a smaller hit.
            hit, digests = 0, []
        # Windowed admission floors:
        #   first_live: earliest page the suffix prefill can attend, so
        #     the restore transfers only [first_live, hit);
        #   p0: earliest page anything can attend after admission.
        first_live = max(0, hit * page - window + 1) // page if window \
            else 0
        p0 = max(0, n_prompt - window) // page if window else 0
        # Leading pages that never get a pool page: with a store only
        # pages it already holds; store-less every page below p0; the
        # chunked path needs pool pages from first_live.
        if self.sc.prefill_chunk > 0 or store_chain:
            skip = min(first_live, hit)
        else:
            skip = p0
        # Allocate BEFORE restoring: a request waiting under pool
        # pressure retries every step and must not pay the transfer.
        ids = self._alloc(n_pages - skip)
        if ids is None:
            return False  # pool pressure: stay queued
        return self._admit_with_pages(
            slot_idx, work, ids, n_prompt, n_pages, hit, digests,
            skip, first_live,
        )

    def _admit_with_pages(self, slot_idx, work, ids, n_prompt, n_pages,
                          hit, digests, skip, first_live):
        """Everything after a successful allocation: any escaping
        exception refunds the pages (``ids`` may be rebound by the
        restore-failure top-up; the handler sees the latest binding)."""
        try:
            return self._admit_restore_and_prefill(
                slot_idx, work, ids, n_prompt, n_pages, hit, digests,
                skip, first_live,
            )
        except _AdmitPagesRefunded:
            return False
        except BaseException:
            self.free_pages.extend(self._admit_ids_view)
            raise

    def _admit_restore_and_prefill(self, slot_idx, work, ids, n_prompt,
                                   n_pages, hit, digests, skip,
                                   first_live):
        cfg = self.cfg
        page = cfg.page_size
        self._admit_ids_view = ids
        prefix_kvs = None
        kp = vp = None
        if hit > 0:
            # Restore the in-window hit pages with one batched store
            # call; the digests come from the probe. Outcome: 0 restored,
            # 1 evicted, 2 failed (agreed over the mesh: the worst counts).
            outcome, err = 0, None
            n_restore = (hit - first_live) * cfg.n_layers * 2
            with self._sp_restore.of(rid=work.req.request_id,
                                     pages=n_restore,
                                     nbytes=n_restore * self._page_bytes):
                try:
                    kp, vp = llama.restore_prefix_pages(
                        self.store, cfg,
                        lambda li, kind: content_page_keys(
                            work.prompt, page, hit, li, kind,
                            digests=digests
                        )[first_live:],
                        hit - first_live,
                        getter=self._get_pages,
                    )
                except InfiniStoreKeyNotFound:
                    outcome = 1
                except Exception as e:
                    outcome, err = 2, e
            self._fold_store_stats()
            outcome = self._agree(outcome, largest=True)
            if outcome == 1:
                # Evicted between probe and restore: a miss for this
                # admission only; the store stays in use.
                self.stats["restore_misses"] += 1
                hit = 0
            elif outcome == 2:
                self._store_failed("restore", err)
                hit = 0
            else:
                self.stats["restore_bytes"] += n_restore * self._page_bytes
                kp = kp.to(self.device)
                vp = vp.to(self.device)
                if self.par is not None and self.par.split_heads:
                    # Whole pages from the store; this rank's kv heads.
                    kp, vp = self.par.head_slice(kp), self.par.head_slice(vp)
                if self.sc.prefill_chunk == 0:
                    # Contiguous form for the one-shot suffix prefill;
                    # the chunked path attends straight over the pages.
                    prefix_kvs = [
                        llama.pages_to_kv(cfg, kp[li][None], vp[li][None],
                                          (hit - first_live) * page)
                        for li in range(cfg.n_layers)
                    ]
                self.stats["prefix_hit_pages"] += hit
                self.stats["restored_pages"] += (
                    (hit - first_live) * cfg.n_layers * 2
                )
            if hit == 0 and skip > 0:
                # Restore failed after a skip-trimmed allocation: the
                # cold path needs the skipped pages after all. Top up,
                # or put everything back and stay queued.
                extra = self._alloc(skip)
                if extra is None:
                    self.free_pages.extend(ids)
                    raise _AdmitPagesRefunded()
                ids = extra + ids
                self._admit_ids_view = ids
                first_live = 0
                skip = 0
        self._do_admit_paged(
            slot_idx, work, ids, n_prompt, n_pages, hit, skip,
            first_live, prefix_kvs, kp, vp,
        )
        work.probe = None  # consumed; a future re-admission re-probes
        return True

    def _do_admit_paged(self, slot_idx, work, ids, n_prompt, n_pages,
                        hit, skip, first_live, prefix_kvs, kp, vp):
        cfg = self.cfg
        page = cfg.page_size
        # page_ids[i] for i < skip are dead placeholders (the scratch
        # page): nothing after admission attends below the band floor,
        # and slot.released = skip keeps them from being freed or
        # offloaded.
        full_ids = [0] * skip + ids
        if hit > skip and kp is not None:
            # A hit implies skip = first_live: the restored pages
            # [first_live, hit) go to the pool targets [skip, hit).
            assert skip == first_live, (skip, first_live)
            self._pool_write(ids[: hit - skip], kp, vp)

        row = np.zeros(self.sc.max_pages_per_seq, dtype=np.int32)
        row[skip:n_pages] = ids
        self._pages_rev += 1  # admission rewrites this slot's row
        if self.sc.prefill_chunk > 0:
            # Chunked admission: no bulk prefill here; _unified_step
            # consumes the prompt tail <= prefill_chunk tokens per step.
            self.page_table[slot_idx] = row
            self.slots[slot_idx] = _Slot(
                work=work, page_ids=full_ids, seq_len=hit * page,
                cached_pages=hit, released=skip, generated=[],
                pending=list(work.prompt[hit * page:]),
            )
            self._release_windowed(self.slots[slot_idx])
            return

        suffix = work.prompt[hit * page:]
        s_real = len(suffix)
        with self._sp_prefill.of(rid=work.req.request_id):
            toks = self._to_device(np.asarray([suffix], dtype=np.int32))
            if prefix_kvs is None:
                # Cold admission: prefill, page out, pool write, last
                # row. Dead prompt pages [0, skip) have no pool page.
                row_dev, kp_s, vp_s = _admit_fused(
                    self.params, cfg, toks, model=self.model, **self._mkw)
                self._pool_write(ids, kp_s[:, skip:], vp_s[:, skip:])
            else:
                # pos0 anchors the trimmed prefix's absolute rope
                # positions.
                with torch.no_grad():
                    logits, kvs = self.model.prefill_with_prefix(
                        self.params, cfg, toks, prefix_kvs,
                        pos0=first_live * page, **self._mkw,
                    )
                # Page out the suffix KV into the pool: a hit implies
                # skip = first_live <= hit, so every suffix page has an
                # id.
                kp_s, vp_s = _stack_pages(cfg, kvs)
                self._pool_write(ids[hit - skip:], kp_s, vp_s)
                row_dev = logits[0, s_real - 1]
            row_host = row_dev.cpu().numpy()
        self.stats["prefill_tokens"] += s_real

        self.page_table[slot_idx] = row

        slot = _Slot(
            work=work, page_ids=full_ids, seq_len=n_prompt,
            cached_pages=hit, released=skip,
        )
        self._emit(slot, [self._pick(work, row_host)])
        self.slots[slot_idx] = slot
        # Windowed models: remaining pages wholly below the band floor
        # go back to the pool (offloaded first, with a store).
        self._release_windowed(slot)

    # ---- decode --------------------------------------------------------

    def _emit(self, slot, tokens):
        """The one place generated tokens enter a slot: appends and fires
        the request's streaming callback once per token."""
        slot.generated.extend(tokens)
        cb = slot.work.req.on_token
        if cb is not None:
            rid = slot.work.req.request_id
            for t in tokens:
                cb(rid, t)

    @staticmethod
    def _probs(req, row):
        """The request's sampling distribution over one logits row
        (temperature + top-k transform, normalized float64)."""
        z = np.asarray(row, dtype=np.float64)
        # Subtract the max before dividing, so a tiny temperature can
        # only push losers to -inf, never produce NaN.
        with np.errstate(over="ignore"):
            z = (z - z.max()) / req.temperature
        if 0 < req.top_k < len(z):  # top_k >= vocab = full distribution
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z = np.where(z >= kth, z, -np.inf)
        p = np.exp(z)
        p /= p.sum()
        return p

    def _pick(self, work, row):
        """Next token from one logits row: greedy by default, seeded
        temperature/top-k sampling when the request asked for it."""
        req = work.req
        if req.temperature <= 0:
            return int(np.argmax(row))
        p = self._probs(req, row)
        return int(work.rng.choice(len(p), p=p))

    def _ensure_pages(self, slot_idx, slot, last_pos):
        """Allocate pages on demand so positions up to and including
        ``last_pos`` are backed. Pages allocated before a failure stay
        owned by the slot."""
        need_idx = last_pos // self.cfg.page_size
        while len(slot.page_ids) <= need_idx:
            ids = self._alloc(1)
            if ids is None:
                return False
            self.page_table[slot_idx, len(slot.page_ids)] = ids[0]
            slot.page_ids.extend(ids)
            self._pages_rev += 1
        return True

    def _ensure_page(self, slot_idx, slot):
        """The KV appended this step lands at position seq_len."""
        return self._ensure_pages(slot_idx, slot, slot.seq_len)

    def _offload_full_pages(self, slot, hi=None, behind=False):
        """Persist the slot's new full pages [lo, hi) to the store
        (finish, preemption and windowed release). Full pages only —
        partial tail pages would poison page-granular prefix matching —
        and not [0, cached_pages) (the store has them) nor [0, released)
        (offloaded when they left the window). The pages go page-major,
        each page's every (layer, kind) together, as one
        :class:`_Offload`, which puts them and waits for the ack.

        With ``behind`` (finish and windowed release while the engine
        has other work) the gathered pages are staged to host memory and
        the offload is handed to the write-behind thread, which writes it
        a run of whole pages at a time (OFFLOAD_RUN_BYTES); the pool
        pages are free once this returns, and a probe misses a page until
        its run is acknowledged. Otherwise (preemption; always under a
        mesh, whose ranks agree on the outcome, and on the int8 wire,
        whose put quantizes on the device) the offload waits for those in
        flight, then the step's thread writes it from the pool's pages in
        one run: the pages are durable in the store before their pool
        pages can be reused. Under tp the kv heads are gathered and tp
        rank 0 puts the whole pages (under ep ep rank 0 puts its own,
        whole); the ranks' agreement on the outcome waits for its
        sync."""
        behind = (behind and self.par is None
                  and not self.sc.quantized_store)
        if not behind:
            self._wait_offloads(0)
        if (self.store is None or not self._store_ok
                or not slot.work.req.cache):
            return
        cfg = self.cfg
        n_full = slot.seq_len // cfg.page_size
        if hi is not None:
            n_full = min(n_full, hi)
        lo = max(slot.cached_pages, slot.released)
        if n_full <= lo:
            return
        new_digests = self._slot_digests(slot, n_full)[lo:]
        group = cfg.n_layers * 2  # store pages a pool page makes
        n_pages = (n_full - lo) * group
        nbytes = n_pages * self._page_bytes
        rid = slot.work.req.request_id
        leader = self.par is None or self.par.leader
        # Its bytes: those this rank puts.
        job = _Offload(self._put_pages, rid, n_full - lo,
                       nbytes if leader else 0)
        queued, submitted = 0, False
        t0 = time.perf_counter_ns()
        with self._sp_offload.of(rid=rid, pages=n_pages, nbytes=nbytes):
            try:
                sel = torch.as_tensor(slot.page_ids[lo:n_full],
                                      dtype=torch.long, device=self.device)
                by_kind = [content_page_keys([], 0, 0, li, kind,
                                             digests=new_digests)
                           for li in range(cfg.n_layers)
                           for kind in ("k", "v")]
                job.keys = [k for page in zip(*by_kind) for k in page]
                with self._sp_gather:
                    pages = torch.stack([self.k_pages.index_select(1, sel),
                                         self.v_pages.index_select(1, sel)],
                                        dim=1)
                    if self.par is not None and self.par.split_heads:
                        pages = self.par.gather_heads(pages)
                    # [L, 2, n, ...] -> page-major [n, L, 2, ...].
                    pages = pages.movedim(2, 0).contiguous()
                job.host = pages.reshape(-1, *cfg.kv_page_shape())
                if behind:
                    queued = self._wait_offloads(OFFLOADS_IN_FLIGHT - 1)
                    stage = getattr(self.store, "stage_pages", None)
                    job.host = (job.host.cpu() if stage is None
                                else stage(job.host))
                    job.run = group * max(1, OFFLOAD_RUN_BYTES
                                          // (group * self._page_bytes))
                    if self._behind is None:
                        self._behind = _WriteBehind(self.store)
                    self._behind.submit(job)
                    submitted = True
                else:
                    job.run = n_pages  # one put, one ack
            except Exception as e:
                job.err = e
            # Its own work: not the wait for room behind other offloads,
            # nor the write (the job's work_ns).
            job.step_ns = time.perf_counter_ns() - t0 - queued
            if not behind and job.err is None and leader:
                job.write(self.store)
        self.stats["offload_n"] += 1
        self._fold_store_stats()
        if submitted:
            self.stats["offload_behind_n"] += 1
        else:
            self._take_back(job)

    def _take_back(self, job):
        """Count one offload, written behind the step or waited for. Its
        outcome is what the ranks of the mesh's inner dim agree on (only
        a waited offload has a mesh)."""
        for k, v in job.stats.items():
            self.stats[k] += v
        if job.dropped:
            return
        self.stats["offload_ns"] += job.step_ns + job.work_ns
        if self._agree(int(job.err is not None), largest=True):
            # The output does not depend on the offload; losing it only
            # costs future cache hits.
            if self._store_ok:
                self._store_failed("offload", job.err)
            return
        self.stats["offload_bytes"] += job.nbytes
        self.stats["offloaded_pages"] += job.pages

    def _fold_offloads(self):
        """Count the offloads the write-behind thread has handed back."""
        wb = self._behind
        if wb is None:
            return
        while True:
            try:
                job = wb.done.get_nowait()
            except queue.Empty:
                break
            wb.in_flight -= 1
            self._take_back(job)
        self._fold_store_stats()

    def _wait_offloads(self, most, counted=True):
        """Take back offloads until at most ``most`` are in flight;
        returns the nanoseconds waited. ``counted``: a wait of the step,
        timed as ``engine.offload.room_wait``."""
        wb = self._behind
        if wb is None or wb.in_flight <= most:
            return 0
        t0 = time.perf_counter_ns()
        with self._sp_room if counted else contextlib.nullcontext():
            while wb.in_flight > most:
                job = wb.done.get()
                wb.in_flight -= 1
                self._take_back(job)
        self._fold_offloads()
        return time.perf_counter_ns() - t0

    def drain(self):
        """Wait until every offload handed to the write-behind thread is
        acknowledged in the store (or has failed) and counted in
        ``stats``. ``run()`` drains before it returns; a caller that
        drives ``step()`` itself drains when it needs the pages there."""
        self._wait_offloads(0, counted=False)

    def _release(self, slot_idx, slot):
        # [0, released) already went back when those pages left the
        # window: freeing them twice would give one page to two slots.
        self.free_pages.extend(slot.page_ids[slot.released:])
        self.slots[slot_idx] = None
        self._pages_rev += 1

    def _release_windowed(self, slot):
        """Sliding-window KV bound: pages whose every position is below
        the band floor (seq_len - window) can never be attended again, so
        they go back to the free list (offloaded first) and live KV stays
        O(window) per slot. The page-table entries keep pointing at the
        freed pages: the kernels skip sub-floor positions and the plain
        versions mask them, so reused contents are never seen.
        ``cfg.window`` is the stack's widest window: 0 where any layer
        attends every position (``models.afmoe``'s mixed stacks), so
        such an engine frees nothing here and skips no page at
        admission."""
        window = getattr(self.cfg, "window", 0)
        if not window:
            return
        dead = (slot.seq_len - window) // self.cfg.page_size
        if dead <= slot.released:
            return
        self._offload_full_pages(slot, hi=dead, behind=True)  # best-effort
        self.free_pages.extend(slot.page_ids[slot.released:dead])
        slot.released = dead

    def _done(self, slot):
        """The slot has its last token: at its budget or at the EOS."""
        return slot.total_generated() >= slot.work.req.max_new_tokens or (
            self.sc.eos_id >= 0 and bool(slot.generated)
            and slot.generated[-1] == self.sc.eos_id
        )

    def _finish(self, slot_idx, slot):
        self.outputs[slot.work.req.request_id] = (
            slot.work.done + slot.generated
        )
        # Behind the step while there is other work for it to hold up:
        # a request waiting or a slot that runs on. A finish that leaves
        # the engine idle offloads synchronously, so the store holds
        # every offloaded page whenever the engine idles.
        busy = bool(self.queue) or any(
            s is not None and s is not slot and not self._done(s)
            for s in self.slots)
        self._offload_full_pages(slot, behind=busy)
        self._release(slot_idx, slot)

    def _preempt(self, slot_idx, slot):
        """Swap the sequence out through the store: persist its new full
        pages, free its pool pages and requeue it at the front; it
        resumes through the prefix-hit path (restore the cached pages,
        recompute only the partial tail page)."""
        self._offload_full_pages(slot)
        work = slot.work
        work.done.extend(slot.generated)
        work.prompt = list(work.prompt) + slot.generated
        work.probe = None  # prompt changed: stale probe
        self._release(slot_idx, slot)
        work.queued_ns = time.perf_counter_ns()
        self.queue.insert(0, work)
        self.stats["preemptions"] += 1

    def step(self):
        """One engine iteration: admit into free slots, then decode one
        token (or a burst, or a verified draft) for every active slot.
        Returns the number of active slots decoded."""
        t0 = time.perf_counter_ns()
        try:
            self._fold_offloads()
            return self._step()
        finally:
            self.stats["step_ns"] += time.perf_counter_ns() - t0
            self.stats["step_n"] += 1

    def _step(self):
        for i in range(self.sc.max_slots):
            if self.slots[i] is None and self.queue:
                work = self.queue[0]
                t0 = time.perf_counter_ns()
                with self._sp_admit.of(rid=work.req.request_id):
                    admitted = self._admit(i, work)
                if admitted:
                    self.queue.pop(0)
                    self.stats["queue_wait_ns"] += t0 - work.queued_ns
                    self.stats["queue_wait_n"] += 1

        active = [
            (i, s) for i, s in enumerate(self.slots) if s is not None
        ]
        if not active:
            return 0

        # Sequences at max_new_tokens finish BEFORE the step (their last
        # token never needs its KV appended).
        for i, s in list(active):
            if self._done(s):
                self._finish(i, s)
        active = [
            (i, s) for i, s in enumerate(self.slots) if s is not None
        ]
        if not active:
            return 0

        if any(s.pending for _, s in active):
            return self._unified_step(active)

        if self.sc.spec_k > 0:
            proposals = {}
            for i, s in active:
                ctx = list(s.work.prompt) + s.generated
                allowed = s.work.req.max_new_tokens - s.total_generated()
                p = list(self.proposer(ctx, self.sc.spec_k))
                p = p[: max(0, allowed - 1)]
                # A buggy proposer must not index out of the vocabulary.
                proposals[i] = [int(t) % self.cfg.vocab_size for t in p]
            if any(proposals.values()):
                return self._spec_decode(active, proposals)
            # Every draft is empty: the single-token path is cheaper.

        # Burst size: every active slot greedy and within budget for k
        # more tokens; a power of 2, as in the JAX engine.
        greedy = all(s.work.req.temperature <= 0 for _, s in active)
        k = 1
        if greedy and self.sc.host_steps > 1:
            k = min(
                self.sc.host_steps,
                min(s.work.req.max_new_tokens - s.total_generated()
                    for _, s in active),
            )
            k = max(k, 1)
            while k & (k - 1):
                k &= k - 1

        for i, s in active:
            if not self._ensure_pages(i, s, s.seq_len + k - 1):
                if k > 1 and self._ensure_page(i, s):
                    # Burst not backable but a single step is: drop the
                    # whole batch to k = 1.
                    k = 1
                else:
                    # Pool exhausted mid-decode: swap this sequence out
                    # through the store if others run; alone, finish
                    # early with what it has rather than deadlock.
                    if len(active) > 1:
                        self._preempt(i, s)
                    else:
                        self._finish(i, s)
                    continue
        active = [
            (i, s) for i, s in enumerate(self.slots) if s is not None
        ]
        if not active:
            return 0

        with self._sp_decode:
            # Steady state: the device already holds this step's inputs
            # (previous greedy step's outputs, same active set, no
            # page-table change), so nothing is uploaded.
            key = (tuple(i for i, _ in active), self._pages_rev)
            if (self._steady is not None and greedy
                    and self._steady[0] == key):
                _, token_dev, lens_dev, rows_dev = self._steady
            else:
                token = np.zeros(self.sc.max_slots, dtype=np.int32)
                seq_lens = np.zeros(self.sc.max_slots, dtype=np.int32)
                rows = np.zeros_like(self.page_table)  # inactive -> scratch 0
                for i, s in active:
                    token[i] = s.generated[-1]
                    seq_lens[i] = s.seq_len
                    rows[i] = self.page_table[i]
                token_dev = self._to_device(token)
                lens_dev = self._to_device(seq_lens)
                rows_dev = self._to_device(rows)
            # Dispatch queues the step's kernels; the one device-to-host
            # copy of the next tokens waits for them.
            if k > 1:
                with self._sp_dispatch:
                    toks_dev, lens_next = _decode_scan(
                        self.params, self.cfg, token_dev, lens_dev,
                        self.k_pages, self.v_pages, rows_dev, k,
                        model=self.model, **self._mkw, **self._gkw,
                    )
                with self._sp_wait:
                    toks = toks_dev.cpu().numpy()  # [B, k]: the one copy
            else:
                with self._sp_dispatch:
                    logits, nxt_dev, lens_next = _decode_fused(
                        self.params, self.cfg, token_dev, lens_dev,
                        self.k_pages, self.v_pages, rows_dev,
                        model=self.model, **self._mkw, **self._gkw,
                    )
                with self._sp_wait:
                    nxt = nxt_dev.cpu().numpy()

        if k > 1:
            trimmed = False
            for i, s in active:
                burst = [int(t) for t in toks[i]]
                if self.sc.eos_id >= 0 and self.sc.eos_id in burst:
                    # Tokens past the EOS are never emitted; their KV
                    # beyond seq_len is masked and later overwritten.
                    burst = burst[: burst.index(self.sc.eos_id) + 1]
                    trimmed = True
                self._emit(s, burst)
                s.seq_len += len(burst)
                self._release_windowed(s)
                self.stats["decoded_tokens"] += len(burst)
            self.stats["decode_steps"] += k
            self.stats["burst_steps"] += 1
            # `key` still holds: nothing since it was computed changed
            # the active set or _pages_rev.
            self._steady = (
                None if trimmed else (key, toks_dev[:, -1].contiguous(),
                                      lens_next, rows_dev)
            )
            return len(active)

        # Reusable next step iff every emitted token is the device's
        # argmax (greedy); samplers, drafts and finishes invalidate.
        self._steady = (
            (key, nxt_dev, lens_next, rows_dev) if greedy else None
        )
        # Read before the next step: under a decode graph the logits are
        # its static output, which the next replay overwrites.
        lhost = _LazyHost(logits)
        for i, s in active:
            if s.work.req.temperature > 0:
                tok = self._pick(s.work, lhost()[i])
            else:
                tok = int(nxt[i])
            self._emit(s, [tok])
            s.seq_len += 1
            self._release_windowed(s)
            self.stats["decoded_tokens"] += 1
        self.stats["decode_steps"] += 1
        return len(active)

    def _verify_batch(self, entries):
        """Multi-token verify plumbing: pack {slot_idx: tokens} into a
        [B, m] batch, m the longest entry (ragged rows park their padding
        in the scratch page via valid_len), run verify_step, and return
        (refreshed active list, per-position argmax [B, m] on the host,
        logits on the device)."""
        B = self.sc.max_slots
        m = max(len(t) for t in entries.values()) if entries else 0
        token = np.zeros((B, m), dtype=np.int32)
        seq_lens = np.zeros(B, dtype=np.int32)
        valid = np.zeros(B, dtype=np.int32)
        rows = np.zeros_like(self.page_table)
        for i, toks in entries.items():
            s = self.slots[i]
            token[i, : len(toks)] = toks
            valid[i] = len(toks)
            seq_lens[i] = s.seq_len
            rows[i] = self.page_table[i]
        active = [
            (i, s) for i, s in enumerate(self.slots)
            if s is not None and i in entries
        ]
        if not active:
            return [], None, None
        logits, _, _ = self.model.verify_step(
            self.params, self.cfg, self._to_device(token),
            self._to_device(seq_lens), self.k_pages, self.v_pages,
            self._to_device(rows), self._to_device(valid), **self._mkw,
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        return active, nxt, logits

    def _unified_step(self, active):
        """Mixed chunked-prefill + decode batch: slots still prefilling
        consume up to ``prefill_chunk`` prompt tokens, decoding slots
        their one token, all in one multi-token verify pass, so a long
        prompt never stalls the others' decode. Decode slots take single
        tokens here; speculation resumes once no slot is prefilling."""
        m = self.sc.prefill_chunk
        self._steady = None  # multi-token advance: device state stale
        entries = {}
        for i, s in active:
            if s.pending:
                entries[i] = s.pending[: min(m, len(s.pending))]
                # Pages were allocated at admission.
            else:
                if not self._ensure_page(i, s):
                    # A prefilling slot is active too: there is another
                    # sequence to yield to.
                    self._preempt(i, s)
                    continue
                entries[i] = [s.generated[-1]]
        active, nxt, logits = self._verify_batch(entries)
        if not active:
            return 0
        lhost = _LazyHost(logits)  # one copy, only if a slot samples
        decoded = False
        for i, s in active:
            t = len(entries[i])
            sampler = s.work.req.temperature > 0
            if s.pending:
                s.pending = s.pending[t:]
                s.seq_len += t
                self._release_windowed(s)
                self.stats["prefill_tokens"] += t
                if not s.pending:
                    # Prompt consumed: its last position's logits give
                    # the first generated token.
                    tok = (self._pick(s.work, lhost()[i, t - 1])
                           if sampler else int(nxt[i, t - 1]))
                    self._emit(s, [tok])
            else:
                tok = (self._pick(s.work, lhost()[i, 0])
                       if sampler else int(nxt[i, 0]))
                self._emit(s, [tok])
                s.seq_len += 1
                self._release_windowed(s)
                self.stats["decoded_tokens"] += 1
                decoded = True
        self.stats["chunk_steps"] += 1
        if decoded:
            self.stats["decode_steps"] += 1
        return len(active)

    def _sample_over_draft(self, work, draft, rows):
        """Rejection-sampling acceptance for a sampled request's draft
        (speculative sampling with a deterministic proposer): draft token
        t at position j is accepted with probability p_j(t); on rejection
        the replacement is drawn from p_j with t zeroed, renormalized, so
        every emitted token is distributed as draft-less sampling. A
        fully accepted draft earns a bonus token from the next row.
        Returns (emitted_tokens, n_draft_accepted)."""
        req = work.req
        emitted = []
        for j, t in enumerate(draft):
            p = self._probs(req, rows[j])
            if work.rng.random() < p[t]:
                emitted.append(int(t))
                continue
            resid = p.copy()
            resid[t] = 0.0
            tot = resid.sum()
            if tot <= 0.0:
                # p was a point mass at the draft token.
                emitted.append(int(t))
                continue
            resid /= tot
            emitted.append(int(work.rng.choice(len(resid), p=resid)))
            return emitted, j
        p = self._probs(req, rows[len(draft)])
        emitted.append(int(work.rng.choice(len(p), p=p)))
        return emitted, len(draft)

    def _spec_decode(self, active, proposals):
        """Speculative step: verify each slot's draft plus the current
        token in one multi-token pass. Greedy requests accept the longest
        argmax-matching prefix + the bonus token; sampled requests accept
        by rejection sampling. Token parity with plain decoding holds up
        to kernel numerics: verify and single-token decode run different
        kernels, so a near-tie within their rounding difference can flip
        a greedy choice."""
        self._steady = None  # multi-token advance: device state stale
        entries = {}
        props = {}
        for i, s in active:
            p = proposals[i]
            if not self._ensure_pages(i, s, s.seq_len + len(p)):
                # Shrink the draft to what the owned pages can back.
                avail = (
                    len(s.page_ids) * self.cfg.page_size - s.seq_len
                )
                if avail < 1:
                    if len(active) > 1:
                        self._preempt(i, s)
                    else:
                        self._finish(i, s)
                    continue
                p = p[: avail - 1]
            entries[i] = [s.generated[-1]] + p
            props[i] = p
        active, nxt, logits = self._verify_batch(entries)
        if not active:
            return 0
        lhost = _LazyHost(logits)  # one copy, only if a slot samples
        for i, s in active:
            p = props[i]
            if s.work.req.temperature > 0:
                appended, a = self._sample_over_draft(
                    s.work, p, lhost()[i]
                )
            else:
                a = 0
                while a < len(p) and p[a] == int(nxt[i, a]):
                    a += 1
                appended = p[:a] + [int(nxt[i, a])]
            if self.sc.eos_id >= 0 and self.sc.eos_id in appended:
                # Nothing after the EOS is emitted; the KV past the
                # truncated seq_len is masked and never offloaded.
                appended = appended[: appended.index(self.sc.eos_id) + 1]
            self._emit(s, appended)
            s.seq_len += len(appended)
            self._release_windowed(s)
            self.stats["spec_proposed"] += len(p)
            # Draft tokens actually emitted (EOS truncation may drop
            # matched ones).
            self.stats["spec_accepted"] += min(a, len(appended))
            self.stats["decoded_tokens"] += len(appended)
        self.stats["decode_steps"] += 1
        return len(active)

    def run(self, requests=()):
        """Submit ``requests``, drive the loop to completion, and return
        {request_id: generated token list}; every offload is acknowledged
        in the store by then (:meth:`drain`)."""
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            before = (len(self.queue), len(self.outputs))
            decoded = self.step()
            progressed = decoded > 0 or (
                (len(self.queue), len(self.outputs)) != before
            )
            if not progressed and not any(
                s is not None for s in self.slots
            ):
                # Every slot is free, so the whole pool is: the head
                # request not admitting means it never will.
                work = self.queue[0]
                if work.done:
                    # A preempted request whose grown prompt outgrew the
                    # pool: finish it with the output it already has.
                    self.queue.pop(0)
                    self.outputs[work.req.request_id] = list(work.done)
                    continue
                raise RuntimeError(
                    f"request {work.req.request_id} needs more pool "
                    f"pages than exist ({self.sc.total_pages - 1} usable); "
                    "completed outputs remain available in .outputs"
                )
        self.drain()
        return dict(self.outputs)
