"""Paged KV cache: a block-pool arena with per-slot block tables
(mirrors ``src/repro/serve/paged_cache.py``).

The sequence-indexed leaves (k / v, and k_scale / v_scale of an int8
cache) live in one shared arena of ``num_blocks`` fixed-size blocks on
the device; each slot owns an ordered block table mapping logical block
-> physical block.  The block allocator is host numpy: blocks are drawn
lazily as a slot grows and returned when the request finishes.  Admission is reservation-based — a request
reserves its worst-case block count before taking a slot, so a mid-flight
``ensure`` can never fail.

The decode step keeps the contiguous cache contract: ``gather_view``
materializes a (L, B, S_view, ...) view from the pages (cached between
decode ticks, rebuilt when block tables or pages change: counted in
``view_rebuilds``), ``apply_decode`` writes each committed slot's new
row into its page, and ``scatter_chunk`` splices a prefill chunk's
rows.  The arena is updated in place (the reference returns new arrays);
the view is a separate tensor, so the two never alias.

Recurrent per-slot states (ssm / conv / wkv / tm_x / cm_x, whisper's
cross caches) are O(1) per slot and stay slot-dense (``classify_cache``):
a finished prefill installs them (``set_slot_state``), ``apply_decode``
takes the new states of the committed slots only, ``gather_view`` hands
them to the step, and ``free_slot`` zeroes them, so a slot's next
request starts from zero state.

``ContiguousKVCache`` puts the classic one-arena-per-slot cache behind
the same interface, so the engine has one code path and paged vs
contiguous can be held bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import factory

__all__ = ["classify_cache", "PagedKVCache", "ContiguousKVCache",
           "make_kv_cache"]

# leaves indexed (Lx, B, S, ...) along the decode sequence: pageable
_SEQ_NAMES = ("k", "v", "k_scale", "v_scale")


def classify_cache(proto: dict, max_len: int):
    """Split an ``init_cache`` dict into its sequence-indexed leaves
    (pageable) and its per-slot state leaves.  Whisper's cross_k /
    cross_v are encoder-length and never paged."""
    seq, state = [], []
    for name, leaf in proto.items():
        if name == "len":
            continue
        if (name in _SEQ_NAMES and leaf.dim() >= 3
                and leaf.shape[2] == max_len):
            seq.append(name)
        else:
            state.append(name)
    return seq, state


class _KVCacheBase:
    """Shared bookkeeping: leaf classification and the slot-dense state
    leaves (Lx, B, ...) on the device."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_len: int,
                 device):
        self.cfg = cfg
        self.b = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        # shapes only: the full contiguous cache is never materialized in
        # paged mode
        proto = factory.init_cache(cfg, batch_slots, max_len,
                                   device="meta")
        self.seq_names, self.state_names = classify_cache(proto, max_len)
        self.seq_shapes = {n: (tuple(proto[n].shape), proto[n].dtype)
                           for n in self.seq_names}
        self.state = {n: torch.zeros(proto[n].shape, dtype=proto[n].dtype,
                                     device=self.device)
                      for n in self.state_names}
        # decode views copied whole from the arena (``gather_view``)
        self.view_rebuilds = 0

    def _lens(self, lens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(lens, np.int32), device=self.device)

    def set_slot_state(self, slot: int, state_rows: dict) -> None:
        """Install a finished prefill's states for one slot: state_rows
        {name: (Lx, ...)} with the batch dim squeezed out."""
        for name in self.state_names:
            if name in state_rows:
                self.state[name][:, slot] = state_rows[name].to(
                    self.state[name].dtype)

    def zero_slot_state(self, slot: int) -> None:
        for name in self.state_names:
            self.state[name][:, slot] = 0

    def _commit_state(self, new_cache: dict, active) -> None:
        """The decode step's new states for the committed slots only."""
        if not self.state_names:
            return
        act = torch.as_tensor(np.asarray(active).reshape(-1).astype(bool),
                              device=self.device)
        for n, old in self.state.items():
            m = act.reshape((1, self.b) + (1,) * (old.dim() - 2))
            self.state[n] = torch.where(m, new_cache[n].to(old.dtype), old)

    def _with_state(self, cache: dict, lens) -> dict:
        cache.update(self.state)
        cache["len"] = self._lens(lens)
        return cache


class PagedKVCache(_KVCacheBase):
    def __init__(self, cfg: ModelConfig, batch_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: int | None = None,
                 device="cuda"):
        super().__init__(cfg, batch_slots, max_len, device)
        self.block_size = block_size
        self.blocks_per_slot = -(-max_len // block_size)
        if num_blocks is None:
            num_blocks = batch_slots * self.blocks_per_slot
        self.num_blocks = num_blocks
        self.view_len = self.blocks_per_slot * block_size
        # arenas: (L, B, S, ...) -> (L, num_blocks, block_size, ...)
        self.pages = {
            n: torch.zeros((shape[0], num_blocks, block_size) + shape[3:],
                           dtype=dtype, device=self.device)
            for n, (shape, dtype) in self.seq_shapes.items()
        }
        # host-side allocator
        self.block_tables = np.zeros((batch_slots, self.blocks_per_slot),
                                     np.int32)
        self.n_blocks = np.zeros(batch_slots, np.int32)
        self._resv = np.zeros(batch_slots, np.int64)
        self._free = list(range(num_blocks - 1, -1, -1))
        self._quarantined: list = []    # fault-drill OOM pressure pool
        self._view = None
        self._view_dirty = True

    # ----------------------------------------------------------- allocator
    def blocks_needed(self, n_tokens: int) -> int:
        return min(-(-n_tokens // self.block_size), self.blocks_per_slot)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Admission control: reserve the worst-case block count for a
        request.  False when the unreserved pool cannot cover it."""
        need = self.blocks_needed(n_tokens) - int(self.n_blocks[slot])
        avail = len(self._free) - int(self._resv.sum())
        if need > avail:
            return False
        self._resv[slot] = max(need, 0)
        return True

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's block table to address ``n_tokens`` tokens
        (draws from the reservation, so it cannot fail post-admission)."""
        need = self.blocks_needed(n_tokens)
        while self.n_blocks[slot] < need:
            if not self._free:
                raise RuntimeError(
                    "paged KV cache exhausted despite reservation — "
                    "allocator invariant violated")
            phys = self._free.pop()
            self.block_tables[slot, self.n_blocks[slot]] = phys
            self.n_blocks[slot] += 1
            if self._resv[slot] > 0:
                self._resv[slot] -= 1
            self._view_dirty = True

    def free_slot(self, slot: int) -> None:
        for j in range(int(self.n_blocks[slot])):
            self._free.append(int(self.block_tables[slot, j]))
        self.n_blocks[slot] = 0
        self._resv[slot] = 0
        self.block_tables[slot] = 0
        self.zero_slot_state(slot)
        self._view_dirty = True

    def quarantine_blocks(self, n: int) -> int:
        """Fault drill: withhold up to ``n`` free blocks to simulate arena
        pressure.  Only blocks beyond the outstanding reservations are
        taken, so admitted requests keep their "ensure cannot fail"
        guarantee and the pressure lands on admission.  Returns how many
        were taken."""
        take = max(0, min(n, len(self._free) - int(self._resv.sum())))
        for _ in range(take):
            self._quarantined.append(self._free.pop())
        return take

    def release_quarantined(self) -> int:
        n = len(self._quarantined)
        self._free.extend(self._quarantined)
        self._quarantined = []
        return n

    def arena_check(self) -> dict:
        """Allocator invariant: every physical block is in exactly one of
        {free, quarantined, some slot's table}, and reservations never
        exceed the free pool.  Raises RuntimeError on violation; returns
        the accounting."""
        allocated = []
        for slot in range(self.b):
            allocated.extend(
                int(x) for x in
                self.block_tables[slot, :int(self.n_blocks[slot])])
        every = (allocated + [int(x) for x in self._free]
                 + [int(x) for x in self._quarantined])
        acct = {"allocated": len(allocated), "free": len(self._free),
                "quarantined": len(self._quarantined),
                "reserved": int(self._resv.sum()),
                "num_blocks": self.num_blocks}
        if len(every) != self.num_blocks or len(set(every)) != len(every) \
                or any(x < 0 or x >= self.num_blocks for x in every):
            raise RuntimeError(
                f"paged arena accounting violated (leaked or double-owned "
                f"blocks): {acct}")
        if acct["reserved"] > acct["free"]:
            raise RuntimeError(
                f"outstanding reservations exceed the free pool: {acct}")
        return acct

    def invalidate_view(self) -> None:
        """Force the next ``gather_view`` to rebuild from the pages (after
        a tick whose writes were not all committed)."""
        self._view_dirty = True

    # --------------------------------------------------------------- views
    def gather_view(self, lens) -> dict:
        """Contiguous (L, B, view_len, ...) cache view for the decode step.
        Rebuilt, and counted in ``view_rebuilds``, only when block tables
        or pages changed; rows past a slot's ``len`` may hold stale pool
        data — masked by attention."""
        if self._view_dirty or self._view is None:
            self.view_rebuilds += 1
            bt = torch.as_tensor(self.block_tables.reshape(-1),
                                 device=self.device)
            self._view = {}
            for n, arena in self.pages.items():
                v = torch.index_select(arena, 1, bt)
                self._view[n] = v.reshape(
                    (arena.shape[0], self.b, self.view_len) + arena.shape[3:])
            self._view_dirty = False
        return self._with_state(dict(self._view), lens)

    def apply_decode(self, new_cache: dict, lens, active) -> None:
        """Commit one decode tick: each active slot's row written at
        ``lens[i]`` goes into its page and its new states replace the
        old; inactive slots' writes are dropped."""
        lens = np.asarray(lens)
        active = np.asarray(active).reshape(-1).astype(bool)
        idx = np.nonzero(active)[0]
        if idx.size:
            logical = np.minimum(lens[idx] // self.block_size,
                                 self.blocks_per_slot - 1)
            phys = self.block_tables[idx, logical]
            off = lens[idx] % self.block_size
            t = {k: torch.as_tensor(v.astype(np.int64), device=self.device)
                 for k, v in (("slot", idx), ("len", lens[idx]),
                              ("phys", phys), ("off", off))}
            for n, arena in self.pages.items():
                arena[:, t["phys"], t["off"]] = \
                    new_cache[n][:, t["slot"], t["len"]].to(arena.dtype)
        # the new view holds this tick's writes for every slot; rows of
        # slots not committed sit beyond their len (masked)
        self._view = {n: new_cache[n] for n in self.seq_names}
        self._commit_state(new_cache, active)

    def scatter_chunk(self, slot: int, rows: dict, start: int,
                      count: int) -> None:
        """Splice a prefill chunk's rows (L, C, ...) into the slot's pages
        at positions start..start+count-1 (the C-count pad rows drop)."""
        if count <= 0:
            return
        positions = start + np.arange(count)
        logical = np.minimum(positions // self.block_size,
                             self.blocks_per_slot - 1)
        phys = torch.as_tensor(
            self.block_tables[slot, logical].astype(np.int64),
            device=self.device)
        off = torch.as_tensor((positions % self.block_size).astype(np.int64),
                              device=self.device)
        for n in self.seq_names:
            self.pages[n][:, phys, off] = rows[n][:, :count].to(
                self.pages[n].dtype)
        self._view_dirty = True


class ContiguousKVCache(_KVCacheBase):
    """The classic one-arena-per-slot cache behind the paged interface."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_len: int,
                 device="cuda", **_):
        super().__init__(cfg, batch_slots, max_len, device)
        self.view_len = max_len
        self.store = {n: torch.zeros(shape, dtype=dtype, device=self.device)
                      for n, (shape, dtype) in self.seq_shapes.items()}

    def blocks_needed(self, n_tokens: int) -> int:
        return 0

    def reserve(self, slot: int, n_tokens: int) -> bool:
        return True

    def ensure(self, slot: int, n_tokens: int) -> None:
        pass

    def free_slot(self, slot: int) -> None:
        # stale K/V rows beyond len are masked; states must be zeroed
        self.zero_slot_state(slot)

    def quarantine_blocks(self, n: int) -> int:
        return 0                      # no arena to pressure

    def release_quarantined(self) -> int:
        return 0

    def arena_check(self) -> dict:
        return {"allocated": 0, "free": 0, "quarantined": 0,
                "reserved": 0, "num_blocks": 0}

    def invalidate_view(self) -> None:
        pass                          # gather_view reads the store directly

    def gather_view(self, lens) -> dict:
        return self._with_state(dict(self.store), lens)

    def apply_decode(self, new_cache: dict, lens, active) -> None:
        lens_t = self._lens(lens).long()
        act = torch.as_tensor(np.asarray(active).reshape(-1).astype(bool),
                              device=self.device)
        for n, old in self.store.items():
            s = old.shape[2]
            at_pos = ((torch.arange(s, device=self.device)[None, :]
                       == lens_t[:, None]) & act[:, None])      # (B, S)
            m = at_pos.reshape((1, self.b, s) + (1,) * (old.dim() - 3))
            self.store[n] = torch.where(m, new_cache[n].to(old.dtype), old)
        self._commit_state(new_cache, active)

    def scatter_chunk(self, slot: int, rows: dict, start: int,
                      count: int) -> None:
        for n in self.seq_names:
            self.store[n][:, slot, start:start + count] = \
                rows[n][:, :count].to(self.store[n].dtype)


def make_kv_cache(cfg: ModelConfig, batch_slots: int, max_len: int,
                  paged: bool = True, block_size: int = 16,
                  num_blocks: int | None = None, device="cuda"):
    if paged:
        return PagedKVCache(cfg, batch_slots, max_len,
                            block_size=block_size, num_blocks=num_blocks,
                            device=device)
    return ContiguousKVCache(cfg, batch_slots, max_len, device=device)
