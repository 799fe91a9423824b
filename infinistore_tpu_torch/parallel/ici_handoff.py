"""A device-resident KV page pool over the ranks of a mesh axis, with
rank-to-rank handoff and tiering over the host store.

Counterpart of ``infinistore_tpu/parallel/ici_handoff.py``. The JAX pool
is one array sharded over a mesh axis, moved by ``shard_map`` +
``ppermute``; here one rank drives one device and holds that device's
part: a local [slots + 1, *page_shape] tensor, whose last slot is the
hidden scratch slot that transfer padding lands in.

- A directory maps content keys to (device, slot); ``match_last_index``
  is the store's longest-prefix probe over it. ``put`` places pages on a
  device (first writer wins; ``MemoryError`` past capacity), ``get``
  returns pages on every rank, gathered from the ranks that own them,
  ``drop`` frees slots.
- ``handoff(moves)`` relocates keyed pages between devices in rounds
  that form a matching (each device at most once a source and once a
  destination in a round, as ``ppermute`` requires in the JAX pool; the
  steady prefill -> decode pairing is one round). In a round every
  source sends one fixed-width buffer of its slots to its destination,
  padded with the scratch slot, and the destination scatters it into
  free slots (padding into its scratch slot).
- ``fetch_from_store`` pulls the pages of a pool miss from the host
  store (``cuda.CudaKVStore.get_kv_pages_host``); ``evict_to_store``
  spills resident pages to it and frees their slots.

Transfers go through ``parallel.transport``: NCCL between cards, and
through host memory for ranks that share one card over gloo.

**The directory contract** (the JAX package's): the directory and free
lists are replicated on every rank, and every rank of the group makes
the same sequence of directory-changing calls (``put``, ``drop``,
``handoff``, ``fetch_from_store``, ``evict_to_store``) with the same
keys and devices, since each of them is a collective. The state is a
function of that sequence (free lists are stacks; rounds are scheduled
in the order the moves name their routes), so the replicas agree with
no protocol of their own. Page bytes are read only where they are
needed: ``put``'s pages and ``fetch_from_store``'s store reads on the
rank that owns the device, ``evict_to_store``'s write on rank 0.
"""

import torch
import torch.distributed as dist

from . import transport
from .mesh import device_mesh


def make_pool_mesh(n_devices=None, device="cuda", backend=None):
    """A 1-D DeviceMesh ("pool",) over the ``n_devices`` ranks (default: all) that
    joined with ``mesh.init_process_group``, one device each; prefill
    and decode take disjoint ranges of it. The card unless
    ``device="cpu"``."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return device_mesh((n,), ("pool",), device, backend)


class IciKVPool:
    """Store-keyed KV page pool over ``mesh`` (a DeviceMesh from
    :func:`make_pool_mesh`), ``slots_per_device`` pages of ``page_shape``
    and ``dtype`` on each rank's device. Device d is rank d of the mesh.
    ``rounds`` counts the handoff's transfer rounds."""

    def __init__(self, mesh, page_shape, dtype, slots_per_device):
        self.group = transport.group_of(mesh)
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.page_shape = tuple(page_shape)
        self.dtype = dtype
        self.slots = int(slots_per_device)
        device = torch.device(mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        # This rank's slots, plus the hidden scratch slot at index
        # ``slots``: transfer padding scatters there instead of onto
        # live pages.
        self.buffer = torch.zeros((self.slots + 1, *self.page_shape),
                                  dtype=dtype, device=device)
        self.directory = {}  # key -> (device, slot)
        self._free = [list(range(self.slots)) for _ in range(self.n_dev)]
        self.rounds = 0

    # -- directory (the store-keyed surface) ---------------------------

    def check_exist(self, key):
        return key in self.directory

    def match_last_index(self, keys):
        """Index of the last key of the longest resident prefix, -1 when
        the first key is absent: the store's get_match_last_index."""
        last = -1
        for i, k in enumerate(keys):
            if k not in self.directory:
                break
            last = i
        return last

    def device_of(self, key):
        return self.directory[key][0]

    def free_slots(self, device):
        return len(self._free[device])

    # -- page injection / extraction -----------------------------------

    def put(self, keys, pages, device):
        """Place ``pages`` ([n, *page_shape], page i under keys[i]) on
        ``device``. First writer wins: resident keys are skipped. Only the
        rank that owns ``device`` reads ``pages`` (others may pass None).
        Raises ``MemoryError`` on every rank when the new keys outnumber
        the device's free slots."""
        take = [i for i, k in enumerate(keys) if k not in self.directory]
        if not take:
            return
        if len(take) > len(self._free[device]):
            raise MemoryError(f"device {device}: {len(take)} pages > "
                              f"{len(self._free[device])} free slots")
        slots = [self._free[device].pop() for _ in take]
        if self.rank == device:
            if len(take) < len(keys):
                pages = pages[torch.as_tensor(take, device=pages.device)]
            self.buffer[torch.as_tensor(slots, device=self.buffer.device)] = \
                pages.to(self.buffer.device, self.dtype)
        for i, s in zip(take, slots):
            self.directory[keys[i]] = (device, s)

    def get(self, keys):
        """The pages of ``keys`` (any placement) as one [n, *page_shape]
        tensor on every rank's device: each owning rank broadcasts its
        pages, in device order."""
        out = torch.empty((len(keys), *self.page_shape), dtype=self.dtype,
                          device=self.buffer.device)
        by_dev = {}
        for i, k in enumerate(keys):
            dev, slot = self.directory[k]
            by_dev.setdefault(dev, ([], []))
            by_dev[dev][0].append(i)
            by_dev[dev][1].append(slot)
        for dev in sorted(by_dev):
            rows, slots = by_dev[dev]
            if self.rank == dev:
                part = self.buffer[torch.as_tensor(slots,
                                                   device=out.device)]
            else:
                part = torch.empty((len(rows), *self.page_shape),
                                   dtype=self.dtype, device=out.device)
            if self.n_dev > 1:
                transport.broadcast(part, dev, self.group)
            out[torch.as_tensor(rows, device=out.device)] = part
        return out

    def drop(self, keys):
        """Release the keys' slots (the pages become garbage; the
        directory is the source of truth)."""
        for k in keys:
            dev, slot = self.directory.pop(k)
            self._free[dev].append(slot)

    # -- host-store tiering (store <-> pool) ----------------------------

    def fetch_from_store(self, store, keys, device):
        """Pool miss: pull the pages of ``keys`` that are not resident
        from the host store (a ``cuda.CudaKVStore``) onto ``device``; the
        owning rank reads them (``get_kv_pages_host``). Returns the number
        fetched. An engine's miss flow is ``match_last_index`` (pool), the
        store's ``cached_prefix_len``, this fetch, then :meth:`handoff` to
        where decode runs."""
        missing = [k for k in keys if k not in self.directory]
        if not missing:
            return 0
        if len(missing) > len(self._free[device]):
            raise MemoryError(f"device {device}: fetching {len(missing)} "
                              f"pages > {len(self._free[device])} free "
                              f"slots")
        pages = (store.get_kv_pages_host(missing, self.page_shape,
                                         self.dtype)
                 if self.rank == device else None)
        self.put(missing, pages, device)
        return len(missing)

    def evict_to_store(self, store, keys):
        """Spill resident ``keys`` to the host store and free their slots.
        Every rank gathers the pages and rank 0 alone puts them, with
        ``sync`` (the others must see them committed before they go on);
        its outcome is then agreed over the group, and on a failed put
        every rank raises before any directory change. The store is first
        writer wins, so evicting a key it holds only frees the slot.
        Returns the number spilled."""
        present = [k for k in keys if k in self.directory]
        if not present:
            return 0
        pages = self.get(present)
        err = None
        if self.rank == 0:
            try:
                store.put_kv_pages(present, pages, sync=True)
            except Exception as e:  # every rank raises below
                err = e
        flag = torch.tensor([err is None], dtype=torch.int32,
                            device=self.buffer.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        if not flag.item():
            raise RuntimeError("evict_to_store: rank 0 failed to commit the "
                               "pages; pool slots kept on every rank") from err
        self.drop(present)
        return len(present)

    # -- the handoff ----------------------------------------------------

    def handoff(self, moves):
        """Relocate keyed pages: ``moves`` {key: destination device}.
        Pages move from their directory device to the destination, routes
        grouped by (source, destination) and greedily scheduled into
        rounds in which each device is at most once a source and once a
        destination. The directory and free lists follow."""
        routes = {}
        for key, dst in moves.items():
            src, slot = self.directory[key]
            if src == dst:
                continue
            routes.setdefault((src, dst), []).append((key, slot))
        while routes:
            round_routes = {}
            used_src = set()
            for (src, dst), items in list(routes.items()):
                if dst not in round_routes and src not in used_src:
                    round_routes[dst] = (src, items)
                    used_src.add(src)
                    del routes[(src, dst)]
            self._handoff_round(round_routes)

    def _handoff_round(self, round_routes):
        """round_routes: {dst: (src, [(key, src_slot), ...])}. Each source
        sends [n_xfer, *page] (its largest route's width; shorter routes
        pad with the scratch slot) and each destination scatters what it
        receives into free slots, the padding into its scratch slot."""
        n_xfer = max(len(items) for _src, items in round_routes.values())
        for dst, (_src, items) in round_routes.items():
            if len(items) > len(self._free[dst]):
                raise MemoryError(f"device {dst} has "
                                  f"{len(self._free[dst])} free slots, "
                                  f"{len(items)} pages arriving")
        scratch = self.slots
        sends, recvs, new_loc = [], [], {}
        for dst, (src, items) in sorted(round_routes.items()):
            slots = [self._free[dst].pop() for _ in items]
            for (key, _), slot in zip(items, slots):
                new_loc[key] = (dst, slot)
            pad = [scratch] * (n_xfer - len(items))
            if self.rank == src:
                idx = [s for _, s in items] + pad
                sends.append((self.buffer[torch.as_tensor(
                    idx, device=self.buffer.device)], dst))
            if self.rank == dst:
                buf = torch.empty((n_xfer, *self.page_shape),
                                  dtype=self.dtype, device=self.buffer.device)
                recvs.append((buf, src, slots + pad))
        transport.exchange(sends, [(b, s) for b, s, _ in recvs],
                           self.group).wait()
        for buf, _, slots in recvs:
            self.buffer[torch.as_tensor(slots, device=buf.device)] = buf
        self.rounds += 1
        for key, (dst, slot) in new_loc.items():
            src, old_slot = self.directory[key]
            self.directory[key] = (dst, slot)
            self._free[src].append(old_slot)


__all__ = ["IciKVPool", "make_pool_mesh"]
