"""Continuous-batching generation engine on a fixed slot grid (the port of
`areal_tpu/gen/engine.py`, reduced to the serving slice).

- `n_slots` concurrent sequences share a preallocated KV cache
  [L, S, M, Hkv, hd]; admission fills free slots, completion frees them.
  Slot `n_slots` is the scratch row that admission padding writes into.
- **Batched fresh admission**: prompts with no reusable prefix prefill in
  ONE bucketed call (rows padded to a power of two, padding rows target
  the scratch row).
- **KV prefix reuse**: a freed slot keeps its cache and its token history
  (`seq_tokens`, `retained_len`, indexed by `KVPool`'s radix tree).
  Admission matches each prompt against every retained prefix (longest
  common prefix, best first) and prefills only the suffix
  (`forward_prefill_cached`), so an interruption resume or a multi-turn
  turn pays for its new tokens, not its context.  Reuse across a weight
  swap keeps old-policy K/V behind new-policy decoding (`kv_version`
  records the oldest); `retain_kv_on_reload=False` recomputes instead.
- **Abort reservations**: a slot freed by `abort_all` is withheld from
  fresh prompts for `abort_reserve_s`, so the aborted client's resubmit
  (prompt + accumulated tokens) finds its prefix; admission drains a
  window of the queue and matches it globally before any fresh prompt
  takes a slot.
- **Group fan-out**: the siblings of a GRPO group (`group_id`/`group_n`,
  held for up to `group_hold_s` until the group shares one admission
  window) and other requests sharing a prompt prefix cluster; one
  representative prefills the shared prefix, its K/V is copied into the
  siblings' slots (`ops.kv_copy.copy_kv_prefix`, fused into the suffix
  call) and each sibling prefills only its remainder.
- **Ragged decode**: `step` advances the whole slot grid by `decode_chunk`
  tokens per host round trip, one `forward_decode` per token whose
  attention is the ragged paged-decode kernel, reading each slot's cache
  through the page table (`KVPool`).  Idle slots ride along with their
  cache writes dropped.  There is no dense decode path: on the card decode
  attention always goes through the kernel.
- **Counter-keyed sampling**: the token at cache position p of stream s is
  drawn with key f(seed, s, p), so a stream does not depend on which slot
  it sits in, what else is batched with it, or whether its prompt was
  prefilled fresh, as a suffix, or from a sibling's copied prefix.
- **Speculative decoding** (`spec_decode`): before a step, each active
  slot drafts up to D tokens by prompt lookup over its own history
  (`gen/spec.py`); D is pinned (`spec_draft_len`) or picked from a static
  ladder by the windowed acceptance rate.  When any slot drafted, the
  step is ONE verify dispatch for the whole grid: `forward_verify` at
  T = D + 1, whose attention is the ragged kernel at that T.  Every
  position is sampled with the counter key it would have had in plain
  decode, the leading run of drafts equal to what the sampler drew is
  accepted, and the slot advances by that run plus one (the first
  mismatch's sample is the plain-decode token), so the stream is the
  plain stream at any temperature.  The K/V that rejected positions wrote
  is zeroed before the dispatch returns; `seq_tokens`, `lengths` and the
  radix index only ever see accepted tokens.
- **Telemetry** (`utils/telemetry.py`): `decode_chunk` and `spec_verify`
  events with the `decode_chunk_seconds` histogram (when telemetry is
  on), `admission`/`prefill` events and the admission-wait histogram,
  `interrupt` events from `abort_all`, and a `pause` event with the
  pause-window histogram at every weight swap.

- **Weights**: `load_weights` is the aborting path — every in-flight
  request finishes with "abort", then the new weights (a trainer's `v{N}`
  snapshot, or a model in memory) replace the old and the version
  advances.  `swap_weights_live` is the colocated in-memory publish that
  aborts nothing; `release_memory` and `restage` free and re-arm the
  engine's device memory around a colocated train step.  `step` runs under
  `torch.no_grad()`, because grad mode is per thread and a colocated
  engine steps on its own thread beside a training one.

Left for later slices: length-cohort tiers and migration (the spec
controller so has one tier, 0), the host KV tier, disaggregated handoff,
VLM requests, tensor/expert parallelism and the staged weight swap.
"""

import logging
import os
import queue
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from areal_tpu_torch.gen.kv_pool import KVPool, lcp_ids
from areal_tpu_torch.gen.sampling import root_key, sample_tokens_keyed, stream_keys
from areal_tpu_torch.gen.spec import DEFAULT_SPEC_LADDER, SpecController, propose_draft
from areal_tpu_torch.models.hf import load_hf_params
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    Transformer,
    forward_decode,
    forward_prefill,
    forward_prefill_cached,
    forward_verify,
    init_kv_cache,
    init_params,
)
from areal_tpu_torch.ops.ragged_decode import ragged_supported
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.datapack import round_up_to_bucket

logger = logging.getLogger("areal_tpu_torch.gen.engine")


@dataclass
class GenRequest:
    rid: str
    input_ids: List[int]
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    stop_token_ids: List[int] = field(default_factory=list)
    # group fan-out: siblings sampling the same prompt (a GRPO group) share
    # a key and the expected group size, so admission can hold for the
    # whole group and share its prefix, and clients keep it on one server
    group_id: str = ""
    group_n: int = 0
    trace_id: str = ""  # echoed on the wire
    # filled by the engine
    output_tokens: List[int] = field(default_factory=list)
    output_logprobs: List[float] = field(default_factory=list)
    output_versions: List[int] = field(default_factory=list)
    stop_reason: str = ""
    first_token_ts: float = 0.0  # perf_counter() at the first token
    submit_ts: float = 0.0  # perf_counter() at submit (the admission wait)
    # prompt tokens inherited from resident K/V at admission (a retained
    # prefix or a sibling's shared one); answered on the wire
    cache_hit_tokens: int = 0
    # sampler stream: 0 = allocate at admission; nonzero pins the stream
    stream_id: int = 0
    on_done: Optional[Callable[["GenRequest"], None]] = None

    def finish(self, reason: str):
        self.stop_reason = reason
        if self.on_done is not None:
            self.on_done(self)


class GenEngine:
    """Slot-grid engine.  Thread model: one worker thread calls `step`
    (and owns the slot arrays and the device); `submit` is safe from any
    thread; `abort_all` and `active_count` take `_lock`."""

    def __init__(
        self,
        model_config: TransformerConfig,
        params: Optional[Transformer] = None,
        model_path: Optional[str] = None,
        n_slots: int = 8,
        max_seq_len: int = 2048,
        prompt_bucket: int = 128,
        kv_dtype: str = "bfloat16",
        seed: int = 0,
        decode_chunk: int = 8,
        device: DeviceLike = None,
        kv_reuse: bool = True,
        reuse_min_tokens: int = 16,
        retain_kv_on_reload: bool = True,
        abort_reserve_s: float = 1.0,
        admission_window: Optional[int] = None,
        share_prefix: bool = True,
        group_hold_s: float = 0.05,
        match_window: Optional[int] = None,
        spec_decode: bool = False,
        spec_ladder: Optional[List[int]] = None,
        spec_draft_len: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        cfg = model_config
        if params is None:
            if model_path:
                params, cfg = load_hf_params(model_path, model_config, self.device)
            else:
                params = init_params(cfg, seed, self.device)
        elif next(params.parameters()).device != self.device:
            raise ValueError(f"params live on {next(params.parameters()).device}, "
                             f"engine device is {self.device}")
        self.model = params
        self.model_config = cfg = params.cfg
        if cfg.pos_emb == "learned" and max_seq_len > cfg.max_position_embeddings:
            # positions past the table would read its last row: refuse
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the learned position table "
                f"({cfg.max_position_embeddings}); gpt2-family models cannot "
                "extrapolate positions")
        # speculative decoding: D rides a small static ladder (pinned to
        # (0, spec_draft_len) when that is set); the acceptance controller
        # picks the rung of each step
        self.spec_decode = spec_decode
        if spec_draft_len is not None:
            if spec_draft_len <= 0:
                raise ValueError("spec_draft_len must be positive")
            self.spec_ladder = (0, int(spec_draft_len))
        else:
            self.spec_ladder = tuple(sorted(set(int(d) for d in (
                spec_ladder or DEFAULT_SPEC_LADDER))))
        self.spec_draft_len = spec_draft_len
        self._spec = SpecController(ladder=self.spec_ladder)
        # the ragged kernel's gate, once, at the widest window and the
        # widest query tile (a verify at the ladder's top rung)
        T = max(self.spec_ladder) + 1 if spec_decode else 1
        if not ragged_supported(max_seq_len, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                                T=T, q_dtype=torch_dtype(cfg.dtype),
                                kv_dtype=torch_dtype(kv_dtype)):
            raise ValueError(
                f"the ragged decode kernel does not take {cfg.num_heads} q heads "
                f"over {cfg.num_kv_heads} kv heads of dim {cfg.head_dim_} at "
                f"max_seq_len {max_seq_len} and {T} query rows a slot (the head dim "
                "must be a multiple of 8 and a kv head's query rows must fit one "
                "block's shared memory)"
            )
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.prompt_bucket = prompt_bucket
        self.decode_chunk = max(1, decode_chunk)
        self.kv_dtype = kv_dtype
        self.version = 0
        self.cache = init_kv_cache(cfg, n_slots + 1, max_seq_len, kv_dtype, self.device)
        self._root_key = root_key(seed, self.device)

        # host-side slot state (scratch slot included, never assigned)
        S = n_slots + 1
        self.slot_req: List[Optional[GenRequest]] = [None] * S
        self.lengths = np.zeros(S, np.int32)
        self.last_tokens = np.zeros(S, np.int64)
        self.temperature = np.ones(S, np.float32)
        self.top_p = np.ones(S, np.float32)
        self.top_k = np.zeros(S, np.int32)
        self.stream_ids = np.zeros(S, np.int64)
        self.pool = KVPool(n_slots)
        self.pending: "queue.Queue[GenRequest]" = queue.Queue()
        self._lock = threading.Lock()
        # requests drained from `pending` whose admission pass is in
        # flight: an abort_all landing meanwhile finishes them and bumps
        # _abort_gen, so the pass drops them instead of resurrecting them
        self._admitting: List[GenRequest] = []
        # drained but not admitted (no slot, a reservation, a group hold);
        # first in line at the next pass
        self._holdback: List[GenRequest] = []
        self._abort_gen = 0
        self._next_stream = 1
        # device copy of the decode state, rebuilt when admission or a
        # free dirties the host mirrors
        self._dev_state: Optional[Dict[str, torch.Tensor]] = None
        self._state_dirty = True

        # KV prefix reuse: a freed slot keeps its cache; seq_tokens mirrors
        # each slot's cache content (prompt + generated, the pending last
        # token included) and retained_len the valid prefix of a free slot.
        # reuse_min_tokens is the shortest prefix worth reusing or sharing
        self.kv_reuse = kv_reuse
        self.reuse_min_tokens = reuse_min_tokens
        self.retain_kv_on_reload = retain_kv_on_reload
        self.seq_tokens = np.zeros((S, max_seq_len), np.int64)
        self.retained_len = np.zeros(S, np.int32)
        # weight version of the oldest K/V in each slot's valid prefix
        self.kv_version = np.zeros(S, np.int64)
        # abort reservations: monotonic deadline per abort-freed slot
        self.abort_reserve_s = abort_reserve_s
        self._reserved_until = np.zeros(S, np.float64)
        self.admission_window = admission_window or max(64, 4 * n_slots)
        # the lcp scan touches at most this much of the drained window
        self.match_window = match_window or max(64, 2 * n_slots)
        # group fan-out
        self.share_prefix = share_prefix
        self.group_hold_s = group_hold_s
        self._group_first_seen: Dict[str, float] = {}
        # no-progress guard: a pass that parked everything records the free
        # slots and the earliest expiry, and later passes skip the rescan
        # until something can change
        self._parked_free: Optional[frozenset] = None
        self._parked_until = 0.0
        self.stats = {
            "prefill_calls": 0,
            "prefill_tokens": 0,  # prompt tokens through fresh prefill
            "suffix_calls": 0,
            "suffix_tokens": 0,  # tokens through suffix prefill
            "reused_tokens": 0,  # retained-prefix tokens not recomputed
            "shared_tokens": 0,  # cluster-prefix tokens copied, not recomputed
            "copy_calls": 0,  # suffix calls with a fused fan-out copy
            # abort reservations that lapsed before their owner resubmitted
            "reservations_lapsed": 0,
            # admitted rows that inherited a resident prefix / did not;
            # retained prefixes overwritten before any hit used them; hits
            # whose span is a page-rounded part of a claimed donor's prefix
            "prefix_cache_hits": 0,
            "prefix_cache_misses": 0,
            "prefix_cache_evictions": 0,
            "prefix_cache_partial_hits": 0,
            "decode_calls": 0,  # decode dispatches (one per chunk)
            "decode_steps": 0,  # forward_decode calls (chunk tokens each)
            "ragged_dispatches": 0,
            # pages the kernel read, summed over slots x steps
            "ragged_attended_pages": 0,
            # speculative decoding: draft tokens proposed and accepted, and
            # verify dispatches (each one ragged kernel call a layer)
            "spec_drafted": 0,
            "spec_accepted": 0,
            "verify_calls": 0,
        }

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        if len(req.input_ids) + 1 >= self.max_seq_len:
            req.finish("length")
            return
        req.submit_ts = time.perf_counter()
        self.pending.put(req)

    def submit_batch(self, reqs: List[GenRequest]) -> None:
        """Enqueue a group contiguously, so one admission window sees every
        member and the cluster fan-out can share their prefix; the group
        hold (`group_hold_s`) covers members that straggle in through
        separate submits."""
        for req in reqs:
            self.submit(req)

    def active_count(self) -> int:
        with self._lock:
            return (sum(r is not None for r in self.slot_req) + len(self._admitting)
                    + len(self._holdback) + self.pending.qsize())

    def abort_all(self, reason: str = "abort") -> int:
        """Finish every in-flight, held-back and queued request now; returns
        how many.  Callbacks run after the lock is released (they may
        re-enter).

        Each abort-freed slot keeps its prefix, and one whose prefix is
        longer than `reuse_min_tokens` is reserved for `abort_reserve_s`:
        the aborted client resubmits its prompt plus the tokens it got
        within a round trip, and a fresh prompt taking the slot first would
        overwrite the prefix exactly when it is worth most.  The threshold
        is strictly greater: a resubmit's match is capped below its length,
        so a prefix of exactly `reuse_min_tokens` could never be claimed."""
        deadline = time.monotonic() + self.abort_reserve_s
        to_finish: List[GenRequest] = []
        with self._lock:
            self._abort_gen += 1
            for s, req in enumerate(self.slot_req):
                if req is not None:
                    to_finish.append(req)
                    self.slot_req[s] = None
                    self.retained_len[s] = self.lengths[s]
                    if self.kv_reuse and self.retained_len[s] > self.reuse_min_tokens:
                        self._reserved_until[s] = deadline
                    self.pool.note_free(s, self.seq_tokens[s], int(self.retained_len[s]))
            n_in_slot = len(to_finish)
            to_finish.extend(self._admitting)
            self._admitting = []
            to_finish.extend(self._holdback)
            self._holdback = []
            while True:
                try:
                    to_finish.append(self.pending.get_nowait())
                except queue.Empty:
                    break
            self._state_dirty = True
        if telemetry.is_enabled():
            # only slot-holding requests were mid-decode: those are the
            # interrupt spans the client's resume events pair with
            for req in to_finish[:n_in_slot]:
                telemetry.emit("interrupt", trace_id=req.trace_id or req.rid, reason=reason,
                               version_before=self.version,
                               generated=len(req.output_tokens))
        for req in to_finish:
            req.finish(reason)
        return len(to_finish)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _assign_streams(self, reqs: List[GenRequest], n_rows: int) -> np.ndarray:
        """Sampler streams for one admission batch, in arrival order; a
        nonzero req.stream_id is honoured verbatim.  Pad rows keep 0."""
        streams = np.zeros(n_rows, np.int64)
        with self._lock:
            for i, req in enumerate(reqs):
                if not req.stream_id:
                    req.stream_id = self._next_stream
                    self._next_stream += 1
                streams[i] = req.stream_id
        return streams

    def _apply_group_hold(self, reqs: List[GenRequest]):
        """Park the members of a declared group (`group_id`, `group_n` > 1)
        until the whole group shares one admission window: the fan-out can
        only share a prefix among requests admitted together.  The hold
        lasts at most `group_hold_s` (a sibling that already finished never
        resubmits, so a partial group must admit eventually).  Returns
        (requests to admit, held, hold deadlines)."""
        if self.group_hold_s <= 0 or not any(r.group_id and r.group_n > 1 for r in reqs):
            return reqs, [], []
        now = time.monotonic()
        counts: Dict[str, int] = {}
        need: Dict[str, int] = {}
        for req in reqs:
            if req.group_id and req.group_n > 1:
                counts[req.group_id] = counts.get(req.group_id, 0) + 1
                need[req.group_id] = max(need.get(req.group_id, 0), req.group_n)
        hold: set = set()
        deadlines: List[float] = []
        for gid, cnt in counts.items():
            if cnt >= need[gid]:
                self._group_first_seen.pop(gid, None)
                continue
            first = self._group_first_seen.setdefault(gid, now)
            if now - first < self.group_hold_s:
                hold.add(gid)
                deadlines.append(first + self.group_hold_s)
            else:  # the hold lapsed: admit the partial group
                self._group_first_seen.pop(gid, None)
        if not hold:
            return reqs, [], []
        held = [r for r in reqs if r.group_id in hold]
        return [r for r in reqs if r.group_id not in hold], held, deadlines

    def _plan_clusters(self, entries: List[GenRequest], matched: set) -> List[dict]:
        """Cluster the admission window by shared prompt prefix ->
        [{"members": [entry index], "share": tokens}].

        Declared groups cluster by `group_id`; the rest by content (sorted
        by a bounded prefix key, then runs of adjacent lcp, which is exact
        because lcp is an ultrametric).  The shared span is capped at
        min(len) - 1 so every sibling still prefills at least one token
        (its last position's logits seed sampling); a cluster whose span
        is below `reuse_min_tokens` dissolves.  Entries matched to a
        retained slot never become siblings but may serve as the
        representative."""
        cand = [i for i, req in enumerate(entries)
                if len(req.input_ids) > self.reuse_min_tokens]
        if len(cand) < 2:
            return []
        by_gid: Dict[str, List[int]] = {}
        rest: List[int] = []
        for i in cand:
            gid = entries[i].group_id
            (by_gid.setdefault(gid, []) if gid else rest).append(i)
        raw = [m for m in by_gid.values() if len(m) >= 2]
        rest.extend(i for m in by_gid.values() if len(m) == 1 for i in m)
        rest = rest[: self.match_window]  # bound the host-side sort and scan
        if len(rest) >= 2:
            rest.sort(key=lambda i: tuple(entries[i].input_ids[:64]))
            run = [rest[0]]
            run_share: Optional[int] = None
            for prev, cur in zip(rest, rest[1:]):
                lcp = lcp_ids(entries[prev].input_ids, entries[cur].input_ids)
                tentative = lcp if run_share is None else min(run_share, lcp)
                if tentative >= self.reuse_min_tokens:
                    run.append(cur)
                    run_share = tentative
                else:
                    if len(run) >= 2:
                        raw.append(run)
                    run = [cur]
                    run_share = None
            if len(run) >= 2:
                raw.append(run)
        clusters: List[dict] = []
        for members in raw:
            ids0 = entries[members[0]].input_ids
            share = min(lcp_ids(ids0, entries[i].input_ids) for i in members[1:])
            share = min(share, min(len(entries[i].input_ids) for i in members) - 1)
            # a cluster of retained-matched members only has nothing to fan out
            if share >= self.reuse_min_tokens and any(i not in matched for i in members):
                clusters.append({"members": sorted(members), "share": share})
        return clusters

    def _admit(self) -> None:
        """Admit from the held-back requests and a window of the queue.

        1. Group hold: members of a declared group wait (`group_hold_s` at
           most) until the whole group is in the window.
        2. Reuse: with `kv_reuse`, the first `match_window` requests are
           matched against every free slot's retained prefix through the
           radix index; pairs assign greedily, longest lcp first (ties by
           arrival), and each match prefills only its suffix.  A request
           whose best donor a longer match claimed inherits the donor's
           prefix rounded down to a page (with `share_prefix`).
        3. Fan-out: with `share_prefix`, the rest cluster by shared prefix;
           one representative per cluster prefills it (fresh, or riding
           its own retained match), the siblings get a copy of its K/V and
           prefill only their remainder.
        4. Fresh prompts take the free slots that no reservation holds,
           least-valuable retained prefix first; what finds no slot is held
           back for the next pass.

        The fresh rows prefill in one call, then the retained and shared
        rows in one suffix call with the fan-out copy fused in (by then
        every copy source holds its prefix).  A pass that admitted nothing
        parks the rescan until a reservation or hold expires, a slot frees
        or a request arrives.  An `abort_all` landing mid-pass finished
        every request of the pass (they sit in `_admitting`), and the pass
        drops them instead of admitting them behind their callback."""
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        if not free:
            return
        if self._parked_free is not None:
            if (not self.pending.qsize() and time.monotonic() < self._parked_until
                    and frozenset(free) == self._parked_free):
                return
            self._parked_free = None
        with self._lock:
            abort_gen = self._abort_gen
            entries, self._holdback = self._holdback, []
            while len(entries) < self.admission_window:
                try:
                    entries.append(self.pending.get_nowait())
                except queue.Empty:
                    break
            self._admitting = list(entries)
        if not entries:
            return
        held: List[GenRequest] = []
        group_deadlines: List[float] = []
        if self.share_prefix:
            entries, held, group_deadlines = self._apply_group_hold(entries)

        admitted: List[Tuple[int, GenRequest]] = []  # fresh rows (slot, req)
        # suffix rows (slot, req, start, kv_src, shared)
        reuse_admitted: List[tuple] = []
        shared_admitted: List[tuple] = []
        free_set = set(free)
        matched: set = set()
        slot_of_entry: Dict[int, Tuple[int, int]] = {}  # entry -> (slot, lcp)
        cands: List[Tuple[int, int, int]] = []  # (-lcp, entry, slot)
        dev_claimed: set = set()
        if self.kv_reuse:
            cand_set = {s for s in free if self.retained_len[s] >= self.reuse_min_tokens}
            if cand_set:
                for i, req in enumerate(entries[: self.match_window]):
                    # capped at len - 1: one suffix token at least runs
                    # through prefill (its logits seed sampling)
                    limit = len(req.input_ids) - 1
                    for s, lcp in self.pool.match_device(req.input_ids).items():
                        if s not in cand_set:
                            continue
                        toks = self.pool.device_tokens(s)
                        if toks is None or len(toks) != int(self.retained_len[s]):
                            continue  # a stale index entry costs a hit, never fakes one
                        lcp = min(int(lcp), limit)
                        if lcp >= self.reuse_min_tokens:
                            cands.append((-lcp, i, s))
                cands.sort()
                for neg, i, s in cands:
                    if i in matched or s not in free_set:
                        continue
                    matched.add(i)
                    free_set.remove(s)
                    dev_claimed.add(s)
                    slot_of_entry[i] = (s, -neg)
                    reuse_admitted.append((s, entries[i], -neg, s, False))
        # a request whose best match lost its donor to a longer match
        # inherits the donor's prefix up to a page boundary: the donor is
        # claimed this pass (its K/V survives until the suffix call) and
        # its winner writes only from its own lcp >= the span on
        partial_of: Dict[int, Tuple[int, int]] = {}  # entry -> (donor, span)
        if self.share_prefix and dev_claimed:
            page = self.prompt_bucket
            for neg, i, s in cands:  # longest first
                if i in matched or i in partial_of or s not in dev_claimed:
                    continue
                span = ((-neg) // page) * page
                if span >= self.reuse_min_tokens:
                    partial_of[i] = (s, span)

        clusters = self._plan_clusters(entries, matched) if self.share_prefix else []
        cluster_of: Dict[int, int] = {}
        for cid, cl in enumerate(clusters):
            for i in cl["members"]:
                cluster_of[i] = cid
                # a retained-matched member represents the cluster: nobody
                # recomputes the prefix, and the share is capped at its lcp,
                # valid in its row before the suffix call runs
                if "rep_slot" not in cl and i in slot_of_entry:
                    s, lcp = slot_of_entry[i]
                    cl["rep_slot"] = s
                    cl["share"] = min(cl["share"], lcp)

        now = time.monotonic()
        for s in free_set:
            if 0.0 < self._reserved_until[s] <= now:  # the owner never came back
                self._reserved_until[s] = 0.0
                self.stats["reservations_lapsed"] += 1
        open_slots = sorted((s for s in free_set if self._reserved_until[s] <= now),
                            key=lambda s: int(self.retained_len[s]))
        leftover: List[GenRequest] = list(held)
        for i, req in enumerate(entries):
            if i in matched:
                continue
            if not open_slots:
                leftover.append(req)
                if req.group_id:
                    # the group had its window; its leftover members admit
                    # at the next pass instead of waiting out another hold
                    self._group_first_seen[req.group_id] = 0.0
                continue
            s = open_slots.pop(0)
            cid = cluster_of.get(i)
            if cid is not None and clusters[cid].get("rep_slot") is not None:
                shared_admitted.append(
                    (s, req, clusters[cid]["share"], clusters[cid]["rep_slot"], True))
            elif i in partial_of:
                donor, span = partial_of[i]
                self.stats["prefix_cache_partial_hits"] += 1
                shared_admitted.append((s, req, span, donor, True))
            else:
                admitted.append((s, req))
                if cid is not None:  # the first member with a slot represents
                    clusters[cid]["rep_slot"] = s
        with self._lock:
            if self._abort_gen != abort_gen:
                return  # abort_all finished every request of this pass
            self._holdback = leftover + self._holdback
            self._admitting = ([r for _, r in admitted]
                               + [r for _, r, *_ in reuse_admitted + shared_admitted])
        if leftover and not (admitted or reuse_admitted or shared_admitted):
            expiries = [float(self._reserved_until[s]) for s in free
                        if self._reserved_until[s] > now] + group_deadlines
            self._parked_free = frozenset(free)
            self._parked_until = min(expiries) if expiries else now + 0.05
        self.stats["prefix_cache_hits"] += len(reuse_admitted) + len(shared_admitted)
        self.stats["prefix_cache_misses"] += len(admitted)
        if telemetry.is_enabled():
            # before the prefill calls, so a request's admission event
            # precedes its first decode and its finish in the log
            now_pc = time.perf_counter()
            for s, req in admitted:
                self._emit_admission(req, s, "fresh", 0, now_pc)
            for s, req, start, _, shared in reuse_admitted + shared_admitted:
                self._emit_admission(req, s, "shared" if shared else "reuse", start, now_pc)
        if admitted:
            self._admit_fresh_batch(admitted, abort_gen)
        if reuse_admitted or shared_admitted:
            self._admit_suffix_batch(reuse_admitted + shared_admitted, abort_gen)

    @staticmethod
    def _emit_admission(req: GenRequest, slot: int, kind: str, inherited: int,
                        now_pc: float) -> None:
        """Admission and prefill events of one admitted request: its queue
        wait (submit to slot grant, holdback and group hold included) and
        the cold/inherited split of its prompt; `kind` is "fresh", "reuse"
        (its slot's retained prefix) or "shared" (a fan-out copy).  Called
        only when telemetry is on."""
        wait = max(0.0, now_pc - req.submit_ts) if req.submit_ts else 0.0
        telemetry.ADMISSION_WAIT.observe(wait)
        tid = req.trace_id or req.rid
        telemetry.emit("admission", trace_id=tid, kind=kind, slot=int(slot), tier=0,
                       queue_wait_s=wait)
        total = len(req.input_ids)
        telemetry.emit("prefill", trace_id=tid, kind=kind, total_tokens=total,
                       inherited_tokens=int(inherited), cold_tokens=total - int(inherited))

    def _settle_admitted(self, rows: List[tuple], abort_gen: int) -> bool:
        """Under _lock, after a prefill of `rows` ((slot, req, ...)): False
        when an abort_all finished them meanwhile, after forgetting the
        slots' retained prefixes (the prefill overwrote them); True when
        they may take their slots (and leave `_admitting`)."""
        if self._abort_gen != abort_gen:
            for s, *_ in rows:
                self.retained_len[s] = 0
                self.pool.drop_device(s)
            return False
        mine = {id(r) for _, r, *_ in rows}
        self._admitting = [r for r in self._admitting if id(r) not in mine]
        return True

    def _admit_fresh_batch(self, admitted: List[tuple], abort_gen: int) -> None:
        """Full prefill of the admitted prompts in ONE bucketed call (pow2
        rows, padding rows in the scratch row), sampling each first token."""
        bucket = round_up_to_bucket(
            max(len(r.input_ids) for _, r in admitted), self.prompt_bucket,
            self.max_seq_len,
        )
        S = 1 << (len(admitted) - 1).bit_length()
        ids = np.zeros((S, bucket), np.int64)
        plens = np.ones(S, np.int64)
        slot_rows = np.full(S, self.n_slots, np.int64)  # default: scratch
        temp = np.ones(S, np.float32)
        top_p = np.ones(S, np.float32)
        top_k = np.zeros(S, np.int64)
        for i, (s, req) in enumerate(admitted):
            n = len(req.input_ids)
            ids[i, :n] = req.input_ids
            plens[i] = n
            slot_rows[i] = self.pool.row(s)  # write through the page table
            temp[i], top_p[i], top_k[i] = req.temperature, req.top_p, req.top_k
        streams = self._assign_streams([r for _, r in admitted], S)
        dev = self.device
        logits, _ = forward_prefill(
            self.model, torch.from_numpy(ids).to(dev), torch.from_numpy(plens).to(dev),
            self.cache, torch.from_numpy(slot_rows).to(dev),
        )
        keys = stream_keys(self._root_key, torch.from_numpy(streams).to(dev),
                           torch.from_numpy(plens - 1).to(dev))
        toks, logps = sample_tokens_keyed(
            logits.float(), keys, torch.from_numpy(temp).to(dev),
            torch.from_numpy(top_k).to(dev), torch.from_numpy(top_p).to(dev),
        )
        out = torch.stack([toks.double(), logps.double()]).cpu().numpy()  # one download
        toks, logps = out[0].astype(np.int64), out[1]
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(plens[: len(admitted)].sum())
        with self._lock:
            if not self._settle_admitted(admitted, abort_gen):
                return
            for i, (s, req) in enumerate(admitted):
                # a retained prefix nobody matched is overwritten here
                if self.pool.drop_device(s):
                    self.stats["prefix_cache_evictions"] += 1
                self.slot_req[s] = req
                self.lengths[s] = plens[i]
                self.last_tokens[s] = toks[i]
                self.temperature[s] = req.temperature
                self.top_p[s] = req.top_p
                self.top_k[s] = req.top_k
                self.stream_ids[s] = streams[i]
                self.retained_len[s] = 0
                self._reserved_until[s] = 0.0
                self.kv_version[s] = self.version
                self.seq_tokens[s, :plens[i]] = req.input_ids
            self._state_dirty = True
        for i, (s, req) in enumerate(admitted):
            self._record_token(s, int(toks[i]), float(logps[i]))

    def _admit_suffix_batch(self, batch: List[tuple], abort_gen: int) -> None:
        """Suffix-only prefill into slots whose cache holds (or is about to
        receive) the prompt's prefix: ONE bucketed `forward_prefill_cached`
        call.  Rows are (slot, req, start, kv_src, shared): `start` prompt
        tokens are inherited, from `kv_src`'s cache (the slot itself for a
        retained prefix, the cluster's representative or a donor for a
        shared one, copied by the fused fan-out copy).  The slot's
        `kv_version` becomes the oldest of kv_src's and the current one;
        `shared` picks the counter of the inherited tokens."""
        bucket = round_up_to_bucket(
            max(len(r.input_ids) - start for _, r, start, _, _ in batch),
            self.prompt_bucket, self.max_seq_len,
        )
        S = 1 << (len(batch) - 1).bit_length()
        ids = np.zeros((S, bucket), np.int64)
        starts = np.zeros(S, np.int64)
        slens = np.ones(S, np.int64)
        slot_rows = np.full(S, self.n_slots, np.int64)
        copy_src = np.full(S, self.n_slots, np.int64)  # pad: scratch
        temp = np.ones(S, np.float32)
        top_p = np.ones(S, np.float32)
        top_k = np.zeros(S, np.int64)
        max_shared = 0
        for i, (s, req, start, kv_src, shared) in enumerate(batch):
            suffix = req.input_ids[start:]
            ids[i, :len(suffix)] = suffix
            starts[i] = start
            slens[i] = len(suffix)
            slot_rows[i] = self.pool.row(s)
            copy_src[i] = self.pool.row(kv_src)
            temp[i], top_p[i], top_k[i] = req.temperature, req.top_p, req.top_k
            if shared:
                max_shared = max(max_shared, start)
        # the fan-out span on the bucket ladder; 0 (no shared row) skips it
        copy_block = (round_up_to_bucket(max_shared, self.prompt_bucket, self.max_seq_len)
                      if max_shared else 0)
        n = len(batch)
        key_window = round_up_to_bucket(int((starts[:n] + slens[:n]).max()),
                                        self.prompt_bucket, self.max_seq_len)
        streams = self._assign_streams([r for _, r, *_ in batch], S)
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        logits, _ = forward_prefill_cached(
            self.model, put(ids), put(starts), put(slens), self.cache, put(slot_rows),
            copy_src=put(copy_src), copy_block=copy_block, key_window=key_window,
        )
        keys = stream_keys(self._root_key, put(streams), put(starts + slens - 1))
        toks, logps = sample_tokens_keyed(logits.float(), keys, put(temp), put(top_k),
                                          put(top_p))
        out = torch.stack([toks.double(), logps.double()]).cpu().numpy()  # one download
        toks, logps = out[0].astype(np.int64), out[1]
        self.stats["suffix_calls"] += 1
        if copy_block:
            self.stats["copy_calls"] += 1
        self.stats["suffix_tokens"] += int(slens[:n].sum())
        for _, _, start, _, shared in batch:
            self.stats["shared_tokens" if shared else "reused_tokens"] += int(start)
        with self._lock:
            if not self._settle_admitted(batch, abort_gen):
                return
            for i, (s, req, start, kv_src, shared) in enumerate(batch):
                # the slot's index entry retires: used by its own hit, or
                # overwritten by a shared row landing on it (an eviction)
                if self.pool.drop_device(s) and shared:
                    self.stats["prefix_cache_evictions"] += 1
                req.cache_hit_tokens = int(start)
                n_total = len(req.input_ids)
                self.slot_req[s] = req
                self.lengths[s] = n_total
                self.last_tokens[s] = toks[i]
                self.temperature[s] = req.temperature
                self.top_p[s] = req.top_p
                self.top_k[s] = req.top_k
                self.stream_ids[s] = streams[i]
                self.retained_len[s] = 0
                self._reserved_until[s] = 0.0
                self.kv_version[s] = min(int(self.kv_version[kv_src]), self.version)
                self.seq_tokens[s, :n_total] = req.input_ids
            self._state_dirty = True
        for i, (s, req, *_) in enumerate(batch):
            self._record_token(s, int(toks[i]), float(logps[i]))

    def _record_token(self, s: int, tok: int, logp: float) -> None:
        """Deliver a prefill-sampled token; free the slot on a stop."""
        req = self.slot_req[s]
        if req is None:  # aborted between sampling and delivery
            return
        if req.first_token_ts == 0.0:
            req.first_token_ts = time.perf_counter()
        req.output_tokens.append(tok)
        req.output_logprobs.append(logp)
        req.output_versions.append(self.version)
        # its K/V lands at cache position lengths[s] at the next decode step
        self.seq_tokens[s, min(int(self.lengths[s]), self.max_seq_len - 1)] = tok
        n_out = len(req.output_tokens)
        hit_stop = tok in self._stop_ids(req) and n_out >= req.min_new_tokens
        if hit_stop:
            self._free(s, "stop")
        elif n_out >= req.max_new_tokens or self.lengths[s] + 2 >= self.max_seq_len:
            self._free(s, "length")

    def _stop_ids(self, req: GenRequest) -> List[int]:
        eos = self.model_config.eos_token_id
        return req.stop_token_ids or ([eos] if eos is not None else [])

    def _free(self, s: int, reason: str) -> None:
        """Release slot `s`, keeping its cache-backed prefix (positions <
        lengths: the pending last token's K/V was never written)."""
        with self._lock:
            req = self.slot_req[s]
            self.slot_req[s] = None
            self.retained_len[s] = self.lengths[s]
            self.pool.note_free(s, self.seq_tokens[s], int(self.retained_len[s]))
            self._state_dirty = True
        if req is not None:
            req.finish(reason)

    def prefix_cache_hit_rate(self) -> float:
        """Admitted rows that inherited a resident prefix (retained or
        shared) over all admitted rows."""
        h = self.stats["prefix_cache_hits"]
        m = self.stats["prefix_cache_misses"]
        return h / (h + m) if (h + m) else 0.0

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _sync_device_state(self) -> None:  # caller holds _lock
        """Upload the decode state from the host mirrors (only after
        admission or a free changed them)."""
        dev = self.device
        n = self.n_slots

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[:n])).to(dev)

        self._dev_state = {
            "tokens": put(self.last_tokens),
            "lengths": put(self.lengths),
            "streams": put(self.stream_ids),
            "active": put(np.asarray([r is not None for r in self.slot_req])),
            "temp": put(self.temperature),
            "top_p": put(self.top_p),
            "top_k": put(self.top_k),
            "rows": put(self.pool.device_rows()),
        }
        self._state_dirty = False

    def _dispatch_ragged(self, st: Dict[str, torch.Tensor], n: int,
                         active: List[int]) -> np.ndarray:
        """Advance the whole slot grid by `n` decode+sample steps through
        the ragged kernel; returns the [2, n, n_slots] (token, logprob)
        block in one download.  `st` advances in place."""
        M = self.max_seq_len
        page = self.prompt_bucket
        span = int(max(self.lengths[s] for s in active))
        key_window = round_up_to_bucket(span + n, page, M)
        toks, logps = [], []
        tokens, lengths = st["tokens"], st["lengths"]
        for _ in range(n):
            logits, _ = forward_decode(
                self.model, tokens, lengths, self.cache, st["rows"],
                page_size=page, key_window=key_window, active=st["active"],
            )
            keys = stream_keys(self._root_key, st["streams"], lengths)
            tokens, logp = sample_tokens_keyed(
                logits.float(), keys, st["temp"], st["top_k"], st["top_p"])
            lengths = lengths + 1
            toks.append(tokens)
            logps.append(logp)
        st["tokens"], st["lengths"] = tokens, lengths
        out = torch.stack([torch.stack(toks).double(), torch.stack(logps).double()])
        lens = self.lengths[: self.n_slots].astype(np.int64)
        steps = np.arange(1, n + 1, dtype=np.int64)[:, None]
        attended = np.minimum(lens[None, :] + steps, key_window)
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += n
        self.stats["ragged_dispatches"] += 1
        self.stats["ragged_attended_pages"] += int(((attended + page - 1) // page).sum())
        return out.cpu().numpy()

    def _plan_drafts(self, active: List[int]) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Prompt-lookup drafts for this step: (D, drafts [n_slots, D],
        draft lengths [n_slots]), or None when no slot drafted.  D is
        pinned or the controller's rung; each slot's draft is capped by its
        cache room and by the tokens its request has left (the verify
        always emits one token more than it accepts)."""
        d = self.spec_draft_len if self.spec_draft_len is not None else self._spec.draft_len(0)
        if d <= 0:
            return None
        drafts = np.zeros((self.n_slots, d), np.int64)
        dlens = np.zeros(self.n_slots, np.int64)
        for s in active:
            req = self.slot_req[s]
            if req is None:
                continue
            L = int(self.lengths[s])
            cap = min(d, self.max_seq_len - 2 - L,
                      req.max_new_tokens - len(req.output_tokens) - 1)
            if cap <= 0:
                continue
            draft = propose_draft(self.seq_tokens[s, :L + 1], cap)
            drafts[s, :draft.size] = draft
            dlens[s] = draft.size
        return (d, drafts, dlens) if dlens.any() else None

    def _dispatch_verify(self, st: Dict[str, torch.Tensor], active: List[int], d: int,
                         drafts: np.ndarray, dlens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative step for the whole grid: score each slot's
        pending token and its drafts in ONE `forward_verify` at T = D + 1
        (a draftless slot carries draft length 0 and emits exactly its
        plain-decode token), sample all T positions with the counter keys
        plain decode would use, and accept the leading run of drafts that
        equal what the sampler drew.  The slot advances by n_emit = that
        run + 1 on the device; the K/V that rejected positions wrote is
        zeroed before the call returns.  Returns the [2, T, n_slots]
        (token, logprob) block and n_emit [n_slots], in one download."""
        M = self.max_seq_len
        page = self.prompt_bucket
        T = d + 1
        span = int(max(self.lengths[s] for s in active))
        key_window = round_up_to_bucket(span + T, page, M)
        dev = self.device
        B = self.n_slots
        tokens, lengths, act = st["tokens"], st["lengths"], st["active"]
        drafts_d = torch.from_numpy(drafts).to(dev)
        n_write = torch.from_numpy(dlens + 1).to(dev)  # pending token + real drafts
        inputs = torch.cat([tokens[:, None], drafts_d], dim=1)
        logits, _ = forward_verify(
            self.model, inputs, lengths, self.cache, st["rows"], page_size=page,
            key_window=key_window, active=act, n_write=n_write,
        )  # [B, T, V]
        offs = torch.arange(T, device=dev)
        pos = lengths.long()[:, None] + offs[None, :]  # cache position of each row
        keys = stream_keys(self._root_key, st["streams"][:, None], pos)
        sampled, logp = sample_tokens_keyed(
            logits.float().reshape(B * T, -1), keys.reshape(-1),
            st["temp"].repeat_interleave(T), st["top_k"].repeat_interleave(T),
            st["top_p"].repeat_interleave(T))
        sampled, logp = sampled.reshape(B, T), logp.reshape(B, T)
        ok = (sampled[:, :d] == drafts_d) & (offs[None, :d] < n_write[:, None] - 1)
        a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        n_emit = torch.where(act, a + 1, 0)
        # rejected K/V must not outlive this call: zero the positions
        # above the accepted frontier that the verify wrote; the other
        # entries of the index target the scratch row, which nobody reads
        rej = (offs[None, :] >= n_emit[:, None]) & (offs[None, :] < n_write[:, None])
        rej &= act[:, None]
        zrows = torch.where(rej, st["rows"].long()[:, None], self.cache["k"].shape[1] - 1)
        zpos = torch.where(rej, pos, 0)
        for name in ("k", "v"):
            self.cache[name][:, zrows, zpos] = 0
        st["tokens"] = torch.where(act, sampled.gather(1, a[:, None])[:, 0], tokens)
        st["lengths"] = (lengths + n_emit).to(lengths.dtype)
        out = torch.cat([sampled.T.double().reshape(-1), logp.T.double().reshape(-1),
                         n_emit.double()]).cpu().numpy()  # one download
        lens = self.lengths[:B].astype(np.int64)
        attended = np.minimum(lens + T, key_window)
        self.stats["verify_calls"] += 1
        self.stats["spec_drafted"] += int(dlens.sum())
        self.stats["ragged_dispatches"] += 1
        self.stats["ragged_attended_pages"] += int(((attended + page - 1) // page).sum())
        return out[:2 * T * B].reshape(2, T, B), out[2 * T * B:].astype(np.int64)

    @torch.no_grad()
    def step(self, chunk: Optional[int] = None) -> int:
        """Admit pending prompts, then advance every active slot in one
        dispatch: by up to `chunk` tokens of plain decode, or, when spec
        decoding drafted, by each slot's accepted run + 1 in one verify.
        Returns the tokens delivered (overshoot past a stop condition is
        discarded)."""
        if self.cache is None or self.model is None:
            raise RuntimeError("step() after release_memory: restage() first")
        self._admit()
        n = chunk or self.decode_chunk
        with self._lock:
            active = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
            if not active:
                return 0
            if self._dev_state is None or self._state_dirty:
                self._sync_device_state()
            st = self._dev_state
        plan = self._plan_drafts(active) if self.spec_decode else None
        # the per-dispatch telemetry (clock reads, trace-id snapshot) is
        # gated on the flag as a whole
        tele = telemetry.is_enabled()
        if tele:
            trace_ids = [r.trace_id or r.rid for s in active
                         if (r := self.slot_req[s]) is not None]
            t_dispatch = time.perf_counter()
        try:
            if plan is None:
                out = self._dispatch_ragged(st, n, active)
                avail = np.full(self.n_slots, n, np.int64)
            else:
                out, avail = self._dispatch_verify(st, active, *plan)
        except Exception:
            with self._lock:  # the device state may be half advanced
                self._dev_state = None
                self._state_dirty = True
            raise
        if plan is not None:
            drafted = int(plan[2].sum())
            accepted = int(np.maximum(avail - 1, 0).sum())
            self.stats["spec_accepted"] += accepted
            self._spec.record(0, drafted, accepted)
        if tele:
            lat = time.perf_counter() - t_dispatch
            telemetry.DECODE_CHUNK.observe(lat, tier="0")
            if plan is None:
                telemetry.emit("decode_chunk", tier=0, chunk=n, n_active=len(active),
                               latency_s=lat, trace_ids=trace_ids)
            else:
                telemetry.emit("spec_verify", tier=0, draft_len=plan[0], drafted=drafted,
                               accepted=accepted, n_active=len(active), latency_s=lat,
                               trace_ids=trace_ids)
        toks = out[0].astype(np.int64)  # [rows, n_slots]
        logps = out[1]
        delivered = 0
        to_finish: List[tuple] = []
        version = self.version
        with self._lock:
            # re-snapshot: an abort_all may have freed slots meanwhile
            pairs = [(s, self.slot_req[s]) for s in active if self.slot_req[s] is not None]
            for s, req in pairs:
                stops = self._stop_ids(req)
                L = int(self.lengths[s])
                # rows past a slot's avail are rejected drafts: they neither
                # deliver nor trigger a stop
                k, reason = int(avail[s]), ""
                for j in range(k):
                    n_out = len(req.output_tokens) + j + 1
                    if toks[j, s] in stops and n_out >= req.min_new_tokens:
                        k, reason = j + 1, "stop"
                        break
                    # freeing at total + 1 >= max_seq_len keeps the next
                    # decode write in bounds
                    if n_out >= req.max_new_tokens or L + j + 2 >= self.max_seq_len:
                        k, reason = j + 1, "length"
                        break
                req.output_tokens.extend(toks[:k, s].tolist())
                req.output_logprobs.extend(logps[:k, s].tolist())
                req.output_versions.extend([version] * k)
                # delivered tokens sit at cache positions L+1 .. L+k (the
                # pending token's K/V was written at L this step)
                self.seq_tokens[s, L + 1:L + 1 + k] = toks[:k, s]
                self.lengths[s] = L + k
                self.last_tokens[s] = toks[k - 1, s]
                delivered += k
                if reason:
                    self.slot_req[s] = None
                    self.retained_len[s] = self.lengths[s]
                    self.pool.note_free(s, self.seq_tokens[s], int(self.retained_len[s]))
                    to_finish.append((req, reason))
            if to_finish:
                self._state_dirty = True
        for req, reason in to_finish:
            req.finish(reason)
        return delivered

    def spec_acceptance_rates(self) -> List[float]:
        """The controller's windowed acceptance rate per tier (one tier
        here); 0.0 before any verify has reported."""
        return [self._spec.acceptance_rate(0) or 0.0]

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    @staticmethod
    def resolve_ckpt_dir(path: str) -> Tuple[str, Optional[int]]:
        """A trainer publishes atomic snapshots `root/v{N}`: pick the newest
        and return (dir, N).  A plain checkpoint dir (config.json present) is
        used as it is, with version None."""
        if os.path.exists(os.path.join(path, "config.json")):
            return path, None
        vs = sorted(
            (int(m.group(1)), os.path.join(path, d))
            for d in (os.listdir(path) if os.path.isdir(path) else [])
            if (m := re.fullmatch(r"v(\d+)", d))
        )
        if not vs:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return vs[-1][1], vs[-1][0]

    def load_weights(self, path: Optional[str] = None, model: Optional[Transformer] = None,
                     version: Optional[int] = None) -> int:
        """Swap weights, aborting in-flight generation first (clients
        resubmit, and the resubmits reuse their retained prefixes unless
        `retain_kv_on_reload=False`), then adopt the new model as
        `swap_weights_live` does.  The weights are `model`
        (in memory, on the engine's device) or read from `path`: a
        checkpoint dir or a trainer's snapshot root (the newest `v{N}`, or
        exactly `v{version}` when that exists), in which case a missing
        `version` is the snapshot's N.  Without a version the version
        advances by one.  Call from the thread that steps the engine.
        Returns the new version."""
        t0 = time.perf_counter()
        version_before = self.version
        aborted = self.abort_all("abort")
        if aborted:
            logger.info("aborted %d requests for a weight update", aborted)
        if model is None:
            if path is None:
                raise ValueError("load_weights needs a path or a model")
            pinned = os.path.join(path, f"v{int(version)}") if version is not None else None
            if pinned is not None and os.path.isdir(pinned):
                path = pinned
            else:
                path, dir_version = self.resolve_ckpt_dir(path)
                if version is None:
                    version = dir_version
            # the old weights serve on until the new ones have loaded: a
            # failed load raises and leaves the engine as it was
            model, _ = load_hf_params(path, self.model_config, self.device)
        self._swap(model, version)
        self._record_pause(time.perf_counter() - t0, "reload_abort", version_before)
        return self.version

    def _adopt(self, model: Transformer) -> None:
        """Serve `model` from now on (as it is, not copied)."""
        dev = next(model.parameters()).device
        if dev != self.device:
            raise ValueError(f"weights live on {dev}, engine device is {self.device}")
        mine, theirs = self.model_config, model.cfg
        for attr in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                     "num_kv_heads", "head_dim_"):
            if getattr(mine, attr) != getattr(theirs, attr):
                raise ValueError(f"weights have {attr} {getattr(theirs, attr)}, "
                                 f"the engine serves {getattr(mine, attr)}")
        self.model = model

    def swap_weights_live(self, model: Transformer, version: Optional[int] = None) -> int:
        """Non-aborting weight swap: the colocated in-memory publish.

        In-flight requests keep their slots and KV and decode under the new
        weights from the next dispatch on; their per-token
        `output_versions` record the transition, which is the mixed-version
        trajectory the decoupled loss's behaviour weight consumes.  KV
        computed under the old weights stays, and so do the retained and
        shared prefixes of free slots, which later admissions reuse
        (`kv_version` keeps each slot's oldest version).  With
        `retain_kv_on_reload=False` (strict mode, on every swap path) no
        prefix survives: `retained_len` and the reservations are zeroed,
        the radix index cleared and `kv_version` set to the new version.

        `model` is served as it is, not copied: the caller hands over
        tensors nobody else writes (`TorchTrainEngine.export_device_params`
        makes such copies).  Callers that want exact version stamps must not
        race a swap against an in-flight `step()` (`ColocatedEngine` parks
        its stepper first).  `load_weights` shares its `_swap`.  Returns the
        version: `version`, or the old one plus one."""
        t0 = time.perf_counter()
        version_before = self.version
        self._swap(model, version)
        self._record_pause(time.perf_counter() - t0, "swap_live", version_before)
        return self.version

    def _swap(self, model: Transformer, version: Optional[int]) -> None:
        """Adopt `model` and advance the version (both swap paths)."""
        self._adopt(model)
        self.version = int(version) if version is not None else self.version + 1
        if not self.retain_kv_on_reload:
            self.retained_len[:] = 0
            self._reserved_until[:] = 0.0
            self.kv_version[:] = self.version
            self.pool.clear()

    def _record_pause(self, dur: float, kind: str, version_before: int) -> None:
        """Every weight swap's pause window lands in the pause histogram
        (a cold path); with telemetry on, a `pause` event also records the
        version transition."""
        telemetry.PAUSE_WINDOW.observe(dur)
        if telemetry.is_enabled():
            telemetry.emit("pause", kind=kind, dur_s=dur, version_before=version_before,
                           version_after=self.version)

    def release_memory(self, drop_params: bool = True) -> None:
        """Free the device memory this engine holds so a colocated trainer
        can use it: abort every request, drop the KV cache and, with
        `drop_params`, the serving weights.  `restage` re-arms."""
        self.abort_all("abort")
        self.cache = None
        with self._lock:
            self._dev_state = None  # rebuilt from the host mirrors at restage
            self._state_dirty = True
        # the cache is gone: no prefix survives
        self.retained_len[:] = 0
        self._reserved_until[:] = 0.0
        self.kv_version[:] = self.version
        self.pool.clear()
        if drop_params:
            self.model = None

    def restage(self, model: Optional[Transformer] = None,
                version: Optional[int] = None) -> None:
        """Re-arm serving after `release_memory`: adopt `model` (an in-memory
        handoff from a colocated trainer, at `version` when given) or keep
        the current weights, and reallocate the KV cache."""
        if model is not None:
            self._adopt(model)
            if version is not None:
                self.version = int(version)
        elif self.model is None:
            raise RuntimeError("restage() needs a model after release_memory(drop_params=True)")
        if self.cache is None:
            self.cache = init_kv_cache(self.model_config, self.n_slots + 1, self.max_seq_len,
                                       self.kv_dtype, self.device)
            self.pool.reset()  # fresh physical rows: the identity page table

    def generate_blocking(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Synchronous helper (tests, offline use): run until all finish."""
        for r in reqs:
            self.submit(r)
        while any(not r.stop_reason for r in reqs):
            if self.step() == 0:
                # queued work may wait behind a reservation or a group hold
                if self.active_count() == 0:
                    break
                time.sleep(0.001)
        return reqs
