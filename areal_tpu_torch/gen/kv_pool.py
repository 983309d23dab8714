"""Paged KV pool: page table, radix index over resident prefixes and the
host-DRAM overflow tier (the port's copy of `areal_tpu/gen/kv_pool.py`,
which is numpy only).

The serving slice uses the page table: `KVPool.row` and `device_rows` map
a logical slot to its physical cache row, and every decode dispatch reads
and writes the cache through that table.  The radix index, the host tier
and the handoff wire format serve prefix reuse, host offload and
disaggregated handoff, which later slices port.
"""

import base64
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def lcp_ids(a, b) -> int:
    """Longest common prefix of two token sequences (vectorised)."""
    m = min(len(a), len(b))
    if m == 0:
        return 0
    neq = np.asarray(a[:m], np.int64) != np.asarray(b[:m], np.int64)
    return int(neq.argmax()) if neq.any() else m


# ------------------------ handoff wire format --------------------------
# Cross-server KV page streaming: an exported prefix travels
# as JSON — token ids, the host-tier metadata, and each KV array as raw
# bytes base64'd with dtype+shape.  No float conversion anywhere, so an
# export -> wire -> import -> swap-in chain lands byte-for-byte the same
# cache content a local spill/swap-in round trip would (the exactness
# argument for disaggregated handoff rests on this plus the counter-keyed
# sampler streams).


def _wire_array(a: np.ndarray) -> Dict:
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _unwire_array(doc: Dict) -> np.ndarray:
    flat = np.frombuffer(
        base64.b64decode(doc["b64"]), dtype=np.dtype(doc["dtype"])
    )
    return flat.reshape(doc["shape"])


def wire_encode_entry(entry: Dict) -> Dict:
    """JSON-safe wire form of an exported KV entry (the /kv_export
    response body / /kv_import request body)."""
    kv = {k: np.asarray(v) for k, v in entry["kv"].items()}
    return {
        "tokens": [int(t) for t in entry["tokens"]],
        "valid_len": int(entry["valid_len"]),
        "version": int(entry["version"]),
        "block": int(entry["block"]),
        # payload size before base64 inflation — the router's transfer
        # ledger and the handoff telemetry read this
        "nbytes": int(sum(a.nbytes for a in kv.values())),
        "kv": {k: _wire_array(a) for k, a in kv.items()},
    }


def wire_decode_entry(doc: Dict) -> Dict:
    """Inverse of wire_encode_entry; KV arrays come back bit-identical
    (read-only views over the decoded buffer — the import path never
    mutates them)."""
    return {
        "tokens": np.asarray(doc["tokens"], np.int64),
        "valid_len": int(doc["valid_len"]),
        "version": int(doc["version"]),
        "block": int(doc["block"]),
        "kv": {k: _unwire_array(v) for k, v in doc["kv"].items()},
    }


# --------------------------- radix index -------------------------------


class _Node:
    __slots__ = ("children", "entries", "parent")

    def __init__(self, parent: Optional["_Node"] = None):
        # first-token -> (edge tokens np.int64 [e], child node)
        self.children: Dict[int, Tuple[np.ndarray, "_Node"]] = {}
        self.entries: set = set()
        self.parent = parent


@dataclass
class _Entry:
    tokens: np.ndarray  # np.int64 [n] — the full resident transcript prefix
    node: _Node


class RadixIndex:
    """Compressed radix tree over token prefixes.

    Entries are attached at the node whose root path spells their exact
    token sequence; edges compress runs with no branch point.  ``match``
    walks the query once and reports, for EVERY entry, the exact longest
    common prefix with the query — entries hanging off the matched path get
    their divergence depth (including a partial match into the diverging
    edge), entries on the path get their own full length.
    """

    def __init__(self):
        self.root = _Node()
        self._entries: Dict[object, _Entry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def tokens(self, key) -> np.ndarray:
        return self._entries[key].tokens

    def insert(self, key, tokens) -> None:
        """(Re)attach `key` at the node spelling `tokens`, splitting a
        compressed edge at the divergence point when needed."""
        if key in self._entries:
            self.remove(key)
        toks = np.asarray(tokens, np.int64)
        node, d = self.root, 0
        while d < len(toks):
            t0 = int(toks[d])
            hop = node.children.get(t0)
            if hop is None:
                child = _Node(parent=node)
                node.children[t0] = (toks[d:], child)
                node, d = child, len(toks)
                continue
            edge, child = hop
            m = lcp_ids(edge, toks[d:])
            if m == len(edge):
                node, d = child, d + m
                continue
            # split the edge at the divergence point
            mid = _Node(parent=node)
            node.children[t0] = (edge[:m], mid)
            mid.children[int(edge[m])] = (edge[m:], child)
            child.parent = mid
            if d + m == len(toks):
                node, d = mid, len(toks)
            else:
                leaf = _Node(parent=mid)
                mid.children[int(toks[d + m])] = (toks[d + m:], leaf)
                node, d = leaf, len(toks)
        node.entries.add(key)
        self._entries[key] = _Entry(tokens=toks, node=node)

    def remove(self, key) -> Optional[np.ndarray]:
        """Detach `key`; prunes now-empty leaf nodes.  Returns the entry's
        tokens, or None when the key was absent."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return None
        node = ent.node
        node.entries.discard(key)
        # prune empty leaves upward (edges re-merge lazily on insert)
        while (
            node.parent is not None
            and not node.entries
            and not node.children
        ):
            parent = node.parent
            for t0, (edge, child) in list(parent.children.items()):
                if child is node:
                    del parent.children[t0]
                    break
            node = parent
        return ent.tokens

    def clear(self) -> None:
        self.root = _Node()
        self._entries = {}

    def match(self, ids) -> Dict[object, int]:
        """Exact lcp against EVERY entry: {key: lcp(entry.tokens, ids)}."""
        out: Dict[object, int] = {}
        if not self._entries:
            return out
        ids = np.asarray(ids, np.int64)
        node, d = self.root, 0
        while node is not None:
            for key in node.entries:
                out[key] = d  # entry == ids[:d] exactly
            nxt = None
            tok = int(ids[d]) if d < len(ids) else None
            for t0, (edge, child) in node.children.items():
                if tok is not None and t0 == tok:
                    m = lcp_ids(edge, ids[d:])
                    if m == len(edge):
                        nxt = (child, d + m)
                    else:
                        self._collect(child, d + m, out)
                else:
                    self._collect(child, d, out)
            node, d = nxt if nxt is not None else (None, d)
        return out

    def _collect(self, node: _Node, lcp: int, out: Dict[object, int]):
        stack = [node]
        while stack:
            n = stack.pop()
            for key in n.entries:
                out[key] = lcp
            for _, child in n.children.values():
                stack.append(child)


# ------------------------ host overflow tier ---------------------------


@dataclass
class HostEntry:
    tokens: np.ndarray  # np.int64 [vlen]
    valid_len: int
    version: int
    block: int  # bucketed positions held by the kv arrays
    kv: Dict[str, np.ndarray]  # {"k": [L, block, Hkv, hd], "v": ...}
    nbytes: int = field(init=False)

    def __post_init__(self):
        self.nbytes = sum(int(a.nbytes) for a in self.kv.values())


class HostOverflowTier:
    """LRU byte-capped host-DRAM store of spilled KV prefixes.

    Insert evicts least-recently-used entries until the new one fits; a
    take (swap-in) removes the entry — the prefix becomes device-resident
    again and re-enters the radix as a device entry.  Arrays keep the raw
    cache dtype, so a spill/swap-in round trip is bit-identical.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        self._store: "OrderedDict[int, HostEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, hid: int) -> bool:
        return hid in self._store

    def put(self, hid: int, entry: HostEntry) -> List[int]:
        """Insert; returns the hids LRU-evicted to make room.  An entry
        larger than the whole capacity is refused (returned as its own
        eviction) rather than flushing the tier for nothing."""
        if entry.nbytes > self.capacity_bytes:
            return [hid]
        evicted: List[int] = []
        while (
            self.used_bytes + entry.nbytes > self.capacity_bytes
            and self._store
        ):
            old_hid, old = self._store.popitem(last=False)
            self.used_bytes -= old.nbytes
            evicted.append(old_hid)
        self._store[hid] = entry
        self.used_bytes += entry.nbytes
        return evicted

    def take(self, hid: int) -> Optional[HostEntry]:
        ent = self._store.pop(hid, None)
        if ent is not None:
            self.used_bytes -= ent.nbytes
        return ent

    def touch(self, hid: int) -> None:
        if hid in self._store:
            self._store.move_to_end(hid)

    def clear(self) -> int:
        n = len(self._store)
        self._store.clear()
        self.used_bytes = 0
        return n


# ------------------------------ the pool -------------------------------


class KVPool:
    """Radix-fronted paged KV pool for one engine's slot grid.

    Owns the page table (logical slot -> physical cache row), the radix
    index over every resident prefix (device slots and host spills in ONE
    tree), and the optional host overflow tier.  The engine remains the
    owner of the per-slot numpy mirrors (``retained_len``/``seq_tokens``/
    ``kv_version`` — the slot typestate arrays); this object is the lookup
    structure kept in lockstep with them at every acquire/release site.

    Consistency contract: a device entry exists only for a FREE slot and
    mirrors ``seq_tokens[s][:retained_len[s]]`` at insert time; matches are
    additionally validated against the engine's live ``retained_len``
    before use, so a missed bookkeeping call can cost a hit but can never
    fabricate one.
    """

    def __init__(self, n_slots: int, host_bytes: int = 0):
        self.n_slots = n_slots
        self.page_table = np.arange(n_slots + 1, dtype=np.int32)
        self.radix = RadixIndex()
        self.host: Optional[HostOverflowTier] = (
            HostOverflowTier(host_bytes) if host_bytes > 0 else None
        )
        self._next_host_id = 0

    # --- page table -----------------------------------------------------

    def row(self, slot: int) -> int:
        """Physical cache row backing a logical slot."""
        return int(self.page_table[slot])

    def rows_of(self, slots) -> np.ndarray:
        return self.page_table[np.asarray(slots, np.int64)]

    def device_rows(self) -> np.ndarray:
        """Kernel-consumable snapshot of the page table: a contiguous
        int32 copy (the ragged kernel scalar-prefetches it, and the
        decode dispatches upload it as traced data).  A COPY, not a
        view — the live table mutates under migration/free while an
        uploaded snapshot must stay frozen until the next state sync."""
        return np.ascontiguousarray(self.page_table, dtype=np.int32)

    def swap(self, a: int, b: int) -> None:
        """Remap two logical slots' physical rows (tier migration): the
        moving request's KV follows it with zero copies and the displaced
        retained prefix re-homes at the vacated slot.  Radix entries swap
        with their physical rows."""
        pt = self.page_table
        ra, rb = int(pt[a]), int(pt[b])
        pt[a], pt[b] = rb, ra
        ta = self.radix.remove(("dev", a))
        tb = self.radix.remove(("dev", b))
        if ta is not None:
            self.radix.insert(("dev", b), ta)
        if tb is not None:
            self.radix.insert(("dev", a), tb)

    # --- device entries -------------------------------------------------

    def note_free(self, slot: int, seq_row: np.ndarray, valid_len: int):
        """A slot released with `valid_len` retained tokens: (re)index its
        transcript prefix for radix matching."""
        if valid_len > 0:
            self.radix.insert(("dev", slot), seq_row[:valid_len].copy())
        else:
            self.radix.remove(("dev", slot))

    def drop_device(self, slot: int) -> int:
        """A slot's retained prefix is being overwritten (acquire).
        Returns the dropped entry's length (0 when none was indexed)."""
        toks = self.radix.remove(("dev", slot))
        return 0 if toks is None else len(toks)

    def device_tokens(self, slot: int) -> Optional[np.ndarray]:
        key = ("dev", slot)
        return self.radix.tokens(key) if key in self.radix else None

    def match_device(self, ids) -> Dict[int, int]:
        """{slot: exact lcp} over device-resident retained prefixes."""
        return {
            key[1]: l
            for key, l in self.radix.match(ids).items()
            if key[0] == "dev"
        }

    def clear_device(self) -> int:
        """Drop every device entry (strict weight swap / cache release)."""
        dropped = 0
        for key in [k for k in self.radix._entries if k[0] == "dev"]:
            self.radix.remove(key)
            dropped += 1
        return dropped

    # --- host overflow tier ---------------------------------------------

    def host_put(
        self,
        tokens: np.ndarray,
        valid_len: int,
        version: int,
        block: int,
        kv: Dict[str, np.ndarray],
    ) -> int:
        """Spill an evicted prefix to host DRAM; returns how many OLDER
        host entries the LRU evicted to make room (0 when it fit)."""
        assert self.host is not None, "host tier disabled"
        hid = self._next_host_id
        self._next_host_id += 1
        ent = HostEntry(
            tokens=np.asarray(tokens[:valid_len], np.int64).copy(),
            valid_len=valid_len, version=version, block=block, kv=kv,
        )
        evicted = self.host.put(hid, ent)
        if hid not in evicted:
            self.radix.insert(("host", hid), ent.tokens)
        n_evicted = 0
        for old in evicted:
            if old != hid:
                self.radix.remove(("host", old))
            n_evicted += 1
        return n_evicted

    def host_take(self, hid: int) -> Optional[HostEntry]:
        """Remove a host entry for swap-in (it becomes device-resident)."""
        self.radix.remove(("host", hid))
        return self.host.take(hid) if self.host is not None else None

    def host_entry(self, hid: int) -> Optional[HostEntry]:
        return self.host._store.get(hid) if self.host is not None else None

    def match_host(self, ids) -> Dict[int, int]:
        """{hid: exact lcp} over host-spilled prefixes."""
        return {
            key[1]: l
            for key, l in self.radix.match(ids).items()
            if key[0] == "host"
        }

    # --- lifecycle -------------------------------------------------------

    def clear(self) -> None:
        """Strict reset of every resident prefix, device AND host (strict
        weight swap: no old-policy KV may seed new decoding anywhere)."""
        self.radix.clear()
        if self.host is not None:
            self.host.clear()

    def reset(self) -> None:
        """Full reset including the page table (cache released/reallocated:
        physical rows are fresh, identity mapping is correct again)."""
        self.clear()
        self.page_table = np.arange(self.n_slots + 1, dtype=np.int32)

    def check_page_table(self) -> None:
        """The page table must stay a permutation with the scratch row
        pinned — the paged analogue of the slot typestate (a duplicate
        row would alias two slots' KV; a lost row leaks cache)."""
        pt = np.sort(self.page_table)
        if not np.array_equal(pt, np.arange(self.n_slots + 1)):
            raise AssertionError(
                f"page_table is not a permutation: {self.page_table}"
            )
