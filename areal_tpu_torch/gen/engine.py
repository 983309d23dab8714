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
- **Length-cohort tiers** (`decode_tiers`, or `decode_tier_lens` with
  `decode_tier_slots`): the slot grid splits into contiguous blocks with
  ascending length ceilings (`plan_decode_tiers`).  Admission places a
  request in the smallest tier whose ceiling covers its prompt plus its
  token budget (up to roomier tiers when that one is full, down only as a
  last resort), and `step` migrates a slot about to outgrow its ceiling
  into a free slot of a roomier tier: a host-side remap of the page table
  (`KVPool.swap`), no device copy, the destination's retained prefix
  re-homed at the vacated slot.  As in the reference under its ragged
  kernel, tiers are placement policy only: the grid still decodes in ONE
  dispatch, and the counter-keyed sampler makes streams independent of
  where a request sits.
- **Counter-keyed sampling**: the token at cache position p of stream s is
  drawn with key f(seed, s, p), so a stream does not depend on which slot
  it sits in, what else is batched with it, or whether its prompt was
  prefilled fresh, as a suffix, or from a sibling's copied prefix.
- **Speculative decoding** (`spec_decode`): before a step, each active
  slot drafts up to D tokens by prompt lookup over its own history
  (`gen/spec.py`); D is pinned (`spec_draft_len`) or picked for each tier
  from a static ladder by that tier's windowed acceptance rate.  When any
  slot drafted, the step is ONE verify dispatch for the whole grid:
  `forward_verify` at T = D + 1, D the largest that a drafting tier chose,
  whose attention is the ragged kernel at that T.  Every
  position is sampled with the counter key it would have had in plain
  decode, the leading run of drafts equal to what the sampler drew is
  accepted, and the slot advances by that run plus one (the first
  mismatch's sample is the plain-decode token), so the stream is the
  plain stream at any temperature.  The K/V that rejected positions wrote
  is zeroed before the dispatch returns; `seq_tokens`, `lengths` and the
  radix index only ever see accepted tokens.
- **Host KV tier** (`host_offload`, `host_cache_mb`, `host_min_tokens`):
  a retained prefix about to be overwritten is gathered to host memory
  (`ops.kv_copy.gather_kv_prefix`, through a pinned buffer sized for the
  largest block bucket) and kept in `KVPool`'s LRU host tier in the
  cache's dtype; a later radix hit scatters it back into a free row and
  the request suffix-prefills as if the prefix had never left the device.
  The round trip is bit-identical.
- **Disaggregated handoff**: `export_request_kv` gathers the resident
  prefix covering a request's tokens (a device-retained slot first, then
  the host tier) into a host-tier entry; `import_request_kv` installs
  such an entry (off the wire, `gen.kv_pool.wire_decode_entry`) in the
  host tier, where the request that follows hits it through the swap-in.
  A pinned `stream_id` makes the continuation the stream the exporting
  engine would have produced.
- **Telemetry** (`utils/telemetry.py`): `decode_chunk` and `spec_verify`
  events with the `decode_chunk_seconds` histogram (when telemetry is
  on), one per occupied tier with that tier's label, `admission`/`prefill`
  events (with the slot's tier) and the admission-wait histogram,
  `interrupt` events from `abort_all`, and a `pause` event with the
  pause-window histogram at every weight swap.

- **Weights**: `load_weights` is the aborting path — every in-flight
  request finishes with "abort", then the new weights (a trainer's `v{N}`
  snapshot, or a model in memory) replace the old and the version
  advances.  `swap_weights_live` is the colocated in-memory publish that
  aborts nothing.  `stage_params` builds the next weights on the device
  while decoding goes on (a second copy of the weights), and
  `commit_staged` swaps them in by pointer, aborting in-flight requests or
  live: the pause is O(abort), not O(model bytes).  A standby older than
  what a swap installs is dropped, so a later commit never rolls the
  version back.  `release_memory` and `restage` free and re-arm the
  engine's device memory around a colocated train step.  `step` runs under
  `torch.no_grad()`, because grad mode is per thread and a colocated
  engine steps on its own thread beside a training one.

Left for later slices: VLM requests and tensor/expert parallelism.
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
from areal_tpu_torch.gen.kv_pool import KVPool, lcp_ids, nbytes_of
from areal_tpu_torch.gen.sampling import root_key, sample_tokens_keyed, stream_keys
from areal_tpu_torch.gen.spec import DEFAULT_SPEC_LADDER, SpecController, propose_draft
from areal_tpu_torch.models.hf import load_hf_params, params_to_hf_state, state_to_params
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    Transformer,
    forward_decode,
    forward_prefill,
    forward_prefill_cached,
    forward_verify,
    build_model,
    init_kv_cache,
    init_params,
)
from areal_tpu_torch.ops.kv_copy import gather_kv_prefix, scatter_kv_prefix
from areal_tpu_torch.ops.ragged_decode import ragged_supported
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.datapack import round_up_to_bucket

logger = logging.getLogger("areal_tpu_torch.gen.engine")

def plan_decode_tiers(n_slots: int, max_seq_len: int, n_tiers: int,
                      quantum: int = 128) -> Tuple[List[int], List[int]]:
    """The default length-cohort layout: (tier ceilings, slots per tier).

    Ceilings double up to `max_seq_len` (each at least 2 x quantum); slot
    counts halve away from tier 0, where most rollouts live, with the last
    two tiers equal so that the counts sum to `n_slots`:
    n_slots=64, n_tiers=3, max=16384 -> ([4096, 8192, 16384], [32, 16, 16])."""
    if n_tiers <= 1:
        return [max_seq_len], [n_slots]
    if n_slots >> (n_tiers - 1) < 1:
        raise ValueError(f"decode_tiers={n_tiers} needs n_slots >= {1 << (n_tiers - 1)}")
    slots = [n_slots >> (i + 1) for i in range(n_tiers - 1)]
    slots.append(n_slots - sum(slots))
    lens = [max(2 * quantum, max_seq_len >> (n_tiers - 1 - i)) for i in range(n_tiers)]
    lens[-1] = max_seq_len
    return lens, slots


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
        decode_tiers: int = 1,
        decode_tier_lens: Optional[List[int]] = None,
        decode_tier_slots: Optional[List[int]] = None,
        host_offload: bool = False,
        host_cache_mb: int = 64,
        host_min_tokens: int = 32,
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
        # staged weights: (model on the device, version) awaiting commit_staged
        self._standby: Optional[Tuple[Transformer, Optional[int]]] = None  # guarded-by: _lock

        # host-side slot state (scratch slot included, never assigned)
        S = n_slots + 1
        self.slot_req: List[Optional[GenRequest]] = [None] * S
        self.lengths = np.zeros(S, np.int32)
        self.last_tokens = np.zeros(S, np.int64)
        self.temperature = np.ones(S, np.float32)
        self.top_p = np.ones(S, np.float32)
        self.top_k = np.zeros(S, np.int32)
        self.stream_ids = np.zeros(S, np.int64)
        # the page table, the radix index and (with host_offload) the LRU
        # host tier; prefixes shorter than host_min_tokens are not worth a
        # device<->host round trip and just evict
        self.host_min_tokens = host_min_tokens
        self.pool = KVPool(n_slots, host_bytes=(int(host_cache_mb) << 20) if host_offload else 0)
        # the host tier's staging buffer, one row's largest block bucket
        # ([L, max_seq_len, Hkv, hd] per K and V, pinned on the card)
        self._host_buf: Optional[Dict[str, torch.Tensor]] = None
        if self.pool.host is not None and self.device.type == "cuda":
            self._staging()
        self._init_tiers(decode_tiers, decode_tier_lens, decode_tier_slots)
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
            # slots moved to a roomier length-cohort tier (page-table remaps)
            "tier_migrations": 0,
            # device<->host prefix transfers: spills and swap-ins
            "prefix_cache_host_swaps": 0,
            # the disaggregated handoff: /kv_export gathers, /kv_import
            # installs, their K/V bytes both ways, and failures (an export
            # with nothing resident, an import without a host tier)
            "kv_handoff_exports": 0,
            "kv_handoff_imports": 0,
            "kv_handoff_bytes": 0,
            "kv_handoff_failures": 0,
        }

    def _init_tiers(self, n_tiers: int, lens: Optional[List[int]],
                    slots: Optional[List[int]]) -> None:
        """The length-cohort layout: tier t is the contiguous slot block
        [tier_start[t], tier_start[t] + tier_size[t]) with ceiling
        tier_bounds[t] (ascending, the last max_seq_len).  The ceilings
        steer admission and migration; correctness never depends on them."""
        if lens is not None or slots is not None:
            if not (lens and slots):
                raise ValueError("decode_tier_lens and decode_tier_slots come together")
            if len(lens) != len(slots):
                raise ValueError("tier lens/slots length mismatch")
        else:
            lens, slots = plan_decode_tiers(self.n_slots, self.max_seq_len, max(1, n_tiers),
                                            self.prompt_bucket)
        if sum(slots) != self.n_slots:
            raise ValueError(f"decode_tier_slots {slots} must sum to n_slots={self.n_slots}")
        if list(lens) != sorted(lens):
            raise ValueError("decode_tier_lens must ascend")
        self.tier_bounds = [min(int(b), self.max_seq_len) for b in lens]
        self.tier_bounds[-1] = self.max_seq_len
        self.tier_size = [int(c) for c in slots]
        self.tier_start = [int(x) for x in np.cumsum([0] + self.tier_size[:-1])]
        self.n_tiers = len(self.tier_size)
        self.slot_tier = np.zeros(self.n_slots + 1, np.int32)
        for t in range(self.n_tiers):
            lo = self.tier_start[t]
            self.slot_tier[lo:lo + self.tier_size[t]] = t
        self.slot_tier[self.n_slots] = self.n_tiers - 1  # scratch: never decoded

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
        if self.kv_reuse and self.pool.host is not None and free_set:
            self._swap_in_host_hits(entries, matched, free_set, slot_of_entry, reuse_admitted)
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
        # open slots by tier, least valuable retained prefix first; a
        # request lands in the smallest tier whose ceiling covers its
        # prompt and budget, up to roomier tiers when that one is full and
        # down only as a last resort (a migration may follow): a request
        # waits only when no slot is open anywhere
        open_by_tier: List[List[int]] = [[] for _ in range(self.n_tiers)]
        for s in sorted((s for s in free_set if self._reserved_until[s] <= now),
                        key=lambda s: int(self.retained_len[s])):
            open_by_tier[int(self.slot_tier[s])].append(s)
        n_open = sum(len(t) for t in open_by_tier)

        def pick_slot(req: GenRequest) -> int:
            budget = len(req.input_ids) + req.max_new_tokens + 1
            pref = next((t for t, b in enumerate(self.tier_bounds) if b >= budget),
                        self.n_tiers - 1)
            for t in list(range(pref, self.n_tiers)) + list(range(pref - 1, -1, -1)):
                if open_by_tier[t]:
                    return open_by_tier[t].pop(0)
            raise AssertionError("pick_slot with no open slot")

        leftover: List[GenRequest] = list(held)
        for i, req in enumerate(entries):
            if i in matched:
                continue
            if not n_open:
                leftover.append(req)
                if req.group_id:
                    # the group had its window; its leftover members admit
                    # at the next pass instead of waiting out another hold
                    self._group_first_seen[req.group_id] = 0.0
                continue
            s = pick_slot(req)
            n_open -= 1
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
        # retained prefixes about to be overwritten spill to the host tier
        # before a prefill call writes their rows
        overwrite = [s for s, _ in admitted] + [s for s, *_ in shared_admitted]
        if overwrite:
            self._maybe_spill(overwrite)
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

    def _emit_admission(self, req: GenRequest, slot: int, kind: str, inherited: int,
                        now_pc: float) -> None:
        """Admission and prefill events of one admitted request: its queue
        wait (submit to slot grant, holdback and group hold included) and
        the cold/inherited split of its prompt; `kind` is "fresh", "reuse"
        (its slot's retained prefix) or "shared" (a fan-out copy).  Called
        only when telemetry is on."""
        wait = max(0.0, now_pc - req.submit_ts) if req.submit_ts else 0.0
        telemetry.ADMISSION_WAIT.observe(wait)
        tid = req.trace_id or req.rid
        telemetry.emit("admission", trace_id=tid, kind=kind, slot=int(slot),
                       tier=int(self.slot_tier[slot]), queue_wait_s=wait)
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

    def tier_occupancy(self) -> List[int]:
        """Active slots per length-cohort tier (a metrics surface, read from
        the server's threads: a snapshot under the lock)."""
        with self._lock:
            return [sum(self.slot_req[s] is not None
                        for s in range(self.tier_start[t], self.tier_start[t] + self.tier_size[t]))
                    for t in range(self.n_tiers)]

    # ------------------------------------------------------------------
    # the host tier and the disaggregated handoff
    # ------------------------------------------------------------------

    def _host_gather(self, row: int, block: int) -> Dict[str, torch.Tensor]:
        """Positions [0, block) of physical row `row`, copied to host
        memory in the cache's dtype ({key: [L, block, Hkv, hd]}), through
        the pinned staging buffer on the card."""
        src = gather_kv_prefix(self.cache, row, block)
        if self.device.type != "cuda":
            return {k: v.clone() for k, v in src.items()}
        staged = {k: self._staged_view(k, v.shape) for k, v in src.items()}
        for k, v in src.items():
            staged[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return {k: v.clone() for k, v in staged.items()}

    def _host_scatter(self, kv: Dict[str, torch.Tensor], row: int) -> None:
        """Write a host entry's K/V back into physical row `row`, through
        the pinned staging buffer on the card; the bytes land unchanged."""
        if self.device.type != "cuda":
            scatter_kv_prefix(self.cache, kv, row)
            return
        staged = {}
        for k, v in kv.items():
            staged[k] = self._staged_view(k, v.shape)
            staged[k].copy_(v)
        scatter_kv_prefix(self.cache, staged, row)
        # the buffer is reused by the next transfer: wait for this copy
        torch.cuda.current_stream(self.device).synchronize()

    def _staging(self) -> Dict[str, torch.Tensor]:
        """The pinned staging buffer, flat, one row's largest block per K
        and V (an engine without a host tier makes it at its first handoff
        export)."""
        if self._host_buf is None:
            self._host_buf = {k: torch.empty(v[:, 0].numel(), dtype=v.dtype, pin_memory=True)
                              for k, v in self.cache.items()}
        return self._host_buf

    def _staged_view(self, key: str, shape) -> torch.Tensor:
        """A contiguous [L, block, Hkv, hd] view at the buffer's start: one
        DMA each way."""
        n = int(np.prod(shape))
        return self._staging()[key][:n].view(tuple(shape))

    def _maybe_spill(self, slots: List[int]) -> None:
        """Spill the retained prefixes of `slots`, about to be overwritten,
        to the host tier (a no-op without `host_offload`).  A prefix below
        `host_min_tokens` is not worth the round trip and just evicts."""
        if self.pool.host is None or self.cache is None:
            return
        for s in slots:
            vlen = int(self.retained_len[s])
            toks = self.pool.device_tokens(s)
            if toks is None or vlen < self.host_min_tokens or len(toks) != vlen:
                continue  # nothing, too short, or a stale index entry
            block = round_up_to_bucket(vlen, self.prompt_bucket, self.max_seq_len)
            kv = self._host_gather(self.pool.row(s), block)
            evicted = self.pool.host_put(self.seq_tokens[s], vlen, int(self.kv_version[s]),
                                         block, kv)
            self.pool.drop_device(s)
            self.stats["prefix_cache_host_swaps"] += 1
            self.stats["prefix_cache_evictions"] += evicted

    def _swap_in_host_hits(self, entries: List[GenRequest], matched: set, free_set: set,
                           slot_of_entry: Dict[int, Tuple[int, int]],
                           reuse_admitted: List[tuple]) -> None:
        """Admission stage of the host tier: a request the device match
        left cold probes the radix over host-spilled prefixes; a hit
        scatters the spilled K/V back into a free row (the least valuable
        one, whose own prefix spills first when it is worth keeping), and
        the request rides the suffix prefill as a retained hit."""
        now = time.monotonic()
        for i, req in enumerate(entries[: self.match_window]):
            if i in matched or not free_set:
                continue
            host_m = self.pool.match_host(req.input_ids)
            if not host_m:
                continue
            limit = len(req.input_ids) - 1
            best_hid, best_l = None, 0
            for hid, lcp in host_m.items():
                ent = self.pool.host_entry(hid)
                if ent is None:
                    continue
                lcp = min(int(lcp), ent.valid_len, limit)
                if lcp >= self.reuse_min_tokens and lcp > best_l:
                    best_hid, best_l = hid, lcp
            if best_hid is None:
                continue
            open_slots = [s for s in free_set if self._reserved_until[s] <= now]
            if not open_slots:
                return  # nothing can land anywhere this pass
            s = min(open_slots, key=lambda u: int(self.retained_len[u]))
            self._maybe_spill([s])
            ent = self.pool.host_take(best_hid)
            if ent is None:
                continue
            self._host_scatter(ent.kv, self.pool.row(s))
            vlen = ent.valid_len
            with self._lock:
                if self.pool.drop_device(s):
                    self.stats["prefix_cache_evictions"] += 1
                self.seq_tokens[s, :vlen] = ent.tokens
                self.retained_len[s] = vlen
                self.kv_version[s] = ent.version
                self._reserved_until[s] = 0.0
                self.pool.note_free(s, self.seq_tokens[s], vlen)
            self.stats["prefix_cache_host_swaps"] += 1
            matched.add(i)
            free_set.remove(s)
            slot_of_entry[i] = (s, best_l)
            reuse_admitted.append((s, req, best_l, s, False))

    def export_request_kv(self, input_ids: List[int]) -> Optional[dict]:
        """The resident K/V prefix covering `input_ids` as a host-tier
        entry {tokens, valid_len, version, block, kv} for a cross-server
        handoff (/kv_export): the best device-retained match (normally the
        slot of the leg that just finished), else the host tier.  The donor
        stays resident, so a failed import loses nothing.  None (counting a
        failure) when nothing covering `reuse_min_tokens` is resident.
        Call from the thread that steps the engine."""
        limit = len(input_ids) - 1
        best_slot, best_l = None, 0
        if self.cache is not None:
            for s, lcp in self.pool.match_device(input_ids).items():
                toks = self.pool.device_tokens(s)
                if toks is None or len(toks) != int(self.retained_len[s]):
                    continue
                lcp = min(int(lcp), limit)
                if lcp > best_l:
                    best_slot, best_l = s, lcp
        if best_slot is not None and best_l >= self.reuse_min_tokens:
            block = round_up_to_bucket(best_l, self.prompt_bucket, self.max_seq_len)
            entry = {
                "tokens": np.asarray(self.pool.device_tokens(best_slot)[:best_l], np.int64),
                "valid_len": int(best_l),
                "version": int(self.kv_version[best_slot]),
                "block": int(block),
                "kv": self._host_gather(self.pool.row(best_slot), block),
            }
        else:
            best_hid, best_hl = None, 0
            if self.pool.host is not None:
                for hid, lcp in self.pool.match_host(input_ids).items():
                    ent = self.pool.host_entry(hid)
                    if ent is None:
                        continue
                    lcp = min(int(lcp), ent.valid_len, limit)
                    if lcp > best_hl:
                        best_hid, best_hl = hid, lcp
            if best_hid is None or best_hl < self.reuse_min_tokens:
                self.stats["kv_handoff_failures"] += 1
                return None
            ent = self.pool.host_entry(best_hid)
            self.pool.host.touch(best_hid)
            # a partial host match exports the entry's whole block: the
            # importer attends nothing past valid_len
            entry = {"tokens": np.asarray(ent.tokens[:best_hl], np.int64),
                     "valid_len": int(best_hl), "version": int(ent.version),
                     "block": int(ent.block), "kv": ent.kv}
        self.stats["kv_handoff_exports"] += 1
        self.stats["kv_handoff_bytes"] += sum(nbytes_of(a) for a in entry["kv"].values())
        return entry

    def import_request_kv(self, entry: dict) -> bool:
        """Install an exported prefix (/kv_import) as a host-tier entry; the
        request that follows admits through the radix match and the
        swap-in as a warm hit.  False (counting a failure) without a host
        tier; ValueError (counting a failure) for an entry this cache
        cannot take, before anything changes.  Call from the thread that
        steps the engine."""
        if self.pool.host is None:
            self.stats["kv_handoff_failures"] += 1
            return False
        kv = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
              for k, v in entry["kv"].items()}
        fault = self._entry_fault(entry, kv)
        if fault is not None:
            self.stats["kv_handoff_failures"] += 1
            raise ValueError(f"handoff entry refused: {fault}")
        evicted = self.pool.host_put(np.asarray(entry["tokens"], np.int64),
                                     int(entry["valid_len"]), int(entry["version"]),
                                     int(entry["block"]), kv)
        self.stats["prefix_cache_evictions"] += evicted
        self.stats["kv_handoff_imports"] += 1
        self.stats["kv_handoff_bytes"] += sum(nbytes_of(a) for a in kv.values())
        return True

    def _entry_fault(self, entry: dict, kv: Dict[str, torch.Tensor]) -> Optional[str]:
        """Why a handoff entry cannot land in this engine's cache (another
        depth, kv width, dtype or a block past `max_seq_len`, which the
        swap-in would only find inside a later step), or None.  A dtype
        differing from the cache's is refused, never converted: the swap-in
        must land the exporter's bytes."""
        cfg = self.model_config
        valid, block = int(entry["valid_len"]), int(entry["block"])
        tokens = np.asarray(entry["tokens"], np.int64)
        if not 0 < valid <= block <= self.max_seq_len:
            return (f"valid_len {valid} and block {block} must satisfy 0 < valid_len <= "
                    f"block <= max_seq_len {self.max_seq_len}")
        if len(tokens) != valid:
            return f"{len(tokens)} tokens for valid_len {valid}"
        if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            return f"token ids outside the vocabulary of {cfg.vocab_size}"
        if set(kv) != {"k", "v"}:
            return f"kv arrays {sorted(kv)}, want ['k', 'v']"
        want = (cfg.num_layers, block, cfg.num_kv_heads, cfg.head_dim_)
        dtype = torch_dtype(self.kv_dtype)
        for name, a in sorted(kv.items()):
            if tuple(a.shape) != want or a.dtype != dtype:
                return (f"{name} is {tuple(a.shape)} {a.dtype}, this cache takes {want} "
                        f"{dtype}")
        return None

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

    def _plan_drafts(self, active: List[int]
                     ) -> Optional[Tuple[int, np.ndarray, np.ndarray, Dict[int, int]]]:
        """Prompt-lookup drafts for this step: (D, drafts [n_slots, D],
        draft lengths [n_slots], {tier: its D}), or None when no slot
        drafted.  Each occupied tier's D is pinned or its controller's rung;
        the grid verifies at the largest D a drafting tier chose.  Each
        slot's draft is capped by its tier's D, its cache room and the
        tokens its request has left (the verify always emits one token more
        than it accepts)."""
        tier_d: Dict[int, int] = {}
        for s in active:
            t = int(self.slot_tier[s])
            if t not in tier_d:
                tier_d[t] = (self.spec_draft_len if self.spec_draft_len is not None
                             else self._spec.draft_len(t))
        d_max = max(tier_d.values(), default=0)
        if d_max <= 0:
            return None
        drafts = np.zeros((self.n_slots, d_max), np.int64)
        dlens = np.zeros(self.n_slots, np.int64)
        for s in active:
            req = self.slot_req[s]
            if req is None:
                continue
            L = int(self.lengths[s])
            cap = min(tier_d[int(self.slot_tier[s])], self.max_seq_len - 2 - L,
                      req.max_new_tokens - len(req.output_tokens) - 1)
            if cap <= 0:
                continue
            draft = propose_draft(self.seq_tokens[s, :L + 1], cap)
            drafts[s, :draft.size] = draft
            dlens[s] = draft.size
        drafting = {int(self.slot_tier[s]) for s in np.flatnonzero(dlens)}
        if not drafting:
            return None
        d = max(tier_d[t] for t in drafting)
        return d, np.ascontiguousarray(drafts[:, :d]), dlens, {t: tier_d[t] for t in drafting}

    def _plan_migrations(self, n: int) -> None:
        """Move each slot about to outgrow its tier's ceiling within the
        next `n` tokens into a free slot of the smallest roomier tier that
        covers its budget (the top tier always qualifies).  A host-side
        remap: the request keeps its physical row under the new logical
        slot (`KVPool.swap`), the destination's retained prefix re-homes at
        the vacated slot, and nothing is copied on the device.  With no
        roomier slot free the request stays, and its window grows: the
        ceilings are placement hints, never correctness."""
        if self.n_tiers == 1:
            return
        now = time.monotonic()
        free_by_tier: List[List[int]] = [[] for _ in range(self.n_tiers)]
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self._reserved_until[s] <= now:
                free_by_tier[int(self.slot_tier[s])].append(s)
        for slots in free_by_tier:  # overwrite the least valuable retained prefix first
            slots.sort(key=lambda u: int(self.retained_len[u]))
        moves: List[Tuple[int, int]] = []
        for s in range(self.n_slots):
            req = self.slot_req[s]
            t = int(self.slot_tier[s])
            if req is None or t == self.n_tiers - 1:
                continue
            L = int(self.lengths[s])
            if L + n < self.tier_bounds[t]:
                continue  # inside its cohort for the whole step
            need = min(L + max(0, req.max_new_tokens - len(req.output_tokens)) + 1,
                       self.max_seq_len)
            for u in range(t + 1, self.n_tiers):
                if (free_by_tier[u] and self.tier_bounds[u] >= min(need, L + n + 1)
                        and (self.tier_bounds[u] >= need or u == self.n_tiers - 1)):
                    moves.append((s, free_by_tier[u].pop(0)))
                    break
        if not moves:
            return
        with self._lock:
            for s, dst in moves:
                req = self.slot_req[s]
                if req is None:  # aborted since planning
                    continue
                dst_retained = int(self.retained_len[dst])
                dst_version = int(self.kv_version[dst])
                dst_tokens = self.seq_tokens[dst].copy()
                self.slot_req[dst], self.slot_req[s] = req, None
                for arr in (self.lengths, self.last_tokens, self.temperature, self.top_p,
                            self.top_k, self.kv_version, self.stream_ids):
                    arr[dst] = arr[s]
                self.seq_tokens[dst] = self.seq_tokens[s]
                self.retained_len[dst] = 0
                self._reserved_until[dst] = 0.0
                self.pool.swap(s, dst)
                self.seq_tokens[s] = dst_tokens
                self.retained_len[s] = dst_retained
                self.kv_version[s] = dst_version
                self._reserved_until[s] = 0.0
                self.stats["tier_migrations"] += 1
            self._state_dirty = True

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
        # a verify advances a slot by up to D + 1 tokens: migration planning
        # must see the larger step
        self._plan_migrations(max(n, max(self.spec_ladder) + 1) if self.spec_decode else n)
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
            tier_trace: Dict[int, List[str]] = {}
            for s in active:
                if (r := self.slot_req[s]) is not None:
                    tier_trace.setdefault(int(self.slot_tier[s]), []).append(r.trace_id or r.rid)
            t_dispatch = time.perf_counter()
        try:
            if plan is None:
                out = self._dispatch_ragged(st, n, active)
                avail = np.full(self.n_slots, n, np.int64)
            else:
                out, avail = self._dispatch_verify(st, active, *plan[:3])
        except Exception:
            with self._lock:  # the device state may be half advanced
                self._dev_state = None
                self._state_dirty = True
            raise
        tier_spec: Dict[int, Tuple[int, int]] = {}  # tier -> (drafted, accepted)
        if plan is not None:
            dlens = plan[2]
            accepted_s = np.maximum(avail - 1, 0)
            self.stats["spec_accepted"] += int(accepted_s.sum())
            # each drafting tier's controller learns from its own slots
            for t in plan[3]:
                lo, hi = self.tier_start[t], self.tier_start[t] + self.tier_size[t]
                tier_spec[t] = (int(dlens[lo:hi].sum()), int(accepted_s[lo:hi].sum()))
                self._spec.record(t, *tier_spec[t])
        if tele:
            # one event per occupied tier, with its label; the grid ran
            # one dispatch, so every tier's latency is that dispatch's
            lat = time.perf_counter() - t_dispatch
            for t, ids in sorted(tier_trace.items()):
                telemetry.DECODE_CHUNK.observe(lat, tier=str(t))
                if plan is None:
                    telemetry.emit("decode_chunk", tier=t, chunk=n, n_active=len(ids),
                                   latency_s=lat, trace_ids=ids)
                else:
                    drafted, accepted = tier_spec.get(t, (0, 0))
                    telemetry.emit("spec_verify", tier=t, draft_len=plan[3].get(t, 0),
                                   drafted=drafted, accepted=accepted, n_active=len(ids),
                                   latency_s=lat, trace_ids=ids)
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
        """The controller's windowed acceptance rate per tier; 0.0 for a
        tier no verify has reported on."""
        return [self._spec.acceptance_rate(t) or 0.0 for t in range(self.n_tiers)]

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
        """Adopt `model` and advance the version (every swap path).  A
        standby staged at this version or before, or at no version, is
        dropped: committing it later would roll the version back, or
        install older weights under a newer number.  A strictly newer one
        stays for its pending commit."""
        self._adopt(model)
        self.version = int(version) if version is not None else self.version + 1
        if not self.retain_kv_on_reload:
            # the host tier holds old-policy K/V too: every prefix goes
            self.retained_len[:] = 0
            self._reserved_until[:] = 0.0
            self.kv_version[:] = self.version
            self.pool.clear()
        with self._lock:
            if self._standby is not None:
                staged_v = self._standby[1]
                if staged_v is None or staged_v <= self.version:
                    logger.warning("weight swap drops the superseded standby (staged v%s, "
                                   "now v%d)", staged_v, self.version)
                    self._standby = None

    def stage_params(self, params, version: Optional[int] = None) -> bool:
        """Build the next weights on the device while decoding goes on, for
        `commit_staged` to swap in by pointer.  `params` is a `Transformer`
        (one on the engine's device is held as it is; another is copied)
        or HF-named host tensors ({name: tensor}, what a transfer publish
        assembles).  The standby is a second copy of the weights on the
        device: when it does not fit, returns False and the caller keeps
        its host copy for the commit.  Safe from a thread other than the
        stepping one (only the standby slot is shared, under `_lock`)."""
        try:
            model = self.place_params(params)
        except (torch.cuda.OutOfMemoryError, MemoryError) as e:
            logger.warning("weight staging failed (%s); the commit places from host",
                           str(e)[:120])
            with self._lock:
                self._standby = None
            return False
        with self._lock:
            self._standby = (model, None if version is None else int(version))
        return True

    def place_params(self, params) -> Transformer:
        """`params` as a model on the engine's device in the served weights'
        dtype (a model already there is used as it is).  The copies run on
        the calling thread's current stream, the one the decode loop
        launches on, so the standby's memory returns to that stream's pool
        when a later swap frees it."""
        if isinstance(params, Transformer):
            if next(params.parameters()).device == self.device:
                return params
            items = params_to_hf_state(params)
        else:
            items = iter(params.items())
        ref = next(self.model.parameters()) if self.model is not None else None
        dtype = str(ref.dtype).split(".")[-1] if ref is not None else None
        return state_to_params(items, self.model_config, self.device, dtype)

    @property
    def staged_version(self) -> Optional[int]:
        """The staged standby's version, or None when nothing is staged."""
        with self._lock:
            return self._standby[1] if self._standby is not None else None

    @property
    def has_standby(self) -> bool:
        with self._lock:
            return self._standby is not None

    def commit_staged(self, live: bool = False) -> int:
        """Swap the staged weights in: after aborting in-flight requests
        (the default), or live, as `swap_weights_live` does (in-flight
        requests decode on under the new weights, their per-token versions
        record it).  Either way the pause is the abort and a pointer swap.
        Call from the thread that steps the engine.  Returns the version."""
        t0 = time.perf_counter()
        version_before = self.version
        with self._lock:
            if self._standby is None:
                raise RuntimeError("commit_staged without stage_params")
            model, version = self._standby
            self._standby = None
        if not live:
            aborted = self.abort_all("abort")
            if aborted:
                logger.info("aborted %d requests for a staged weight swap", aborted)
        self._swap(model, version)
        self._record_pause(time.perf_counter() - t0, "commit_live" if live else "commit_abort",
                           version_before)
        return self.version

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
            self._standby = None
        # the cache is gone: no prefix survives, on the device or the host
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
