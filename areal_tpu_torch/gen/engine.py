"""Continuous-batching generation engine on a fixed slot grid (the port of
`areal_tpu/gen/engine.py`, reduced to the serving slice).

- `n_slots` concurrent sequences share a preallocated KV cache
  [L, S, M, Hkv, hd]; admission fills free slots, completion frees them.
  Slot `n_slots` is the scratch row that admission padding writes into.
- **Batched fresh admission**: every free slot is filled from the pending
  queue in ONE bucketed prefill (rows padded to a power of two, padding
  rows target the scratch row).
- **Ragged decode**: `step` advances the whole slot grid by `decode_chunk`
  tokens per host round trip, one `forward_decode` per token whose
  attention is the ragged paged-decode kernel, reading each slot's cache
  through the page table (`KVPool`).  Idle slots ride along with their
  cache writes dropped.  There is no dense decode path: on the card decode
  attention always goes through the kernel.
- **Counter-keyed sampling**: the token at cache position p of stream s is
  drawn with key f(seed, s, p), so a stream does not depend on which slot
  it sits in or what else is batched with it.

- **Weight reload** (`load_weights`): the aborting path of the JAX
  engine — every in-flight request finishes with "abort", then the new
  weights (a trainer's `v{N}` snapshot, or a model) replace the old and the
  version advances.

Left for later slices: prefix reuse, suffix prefill, group fan-out,
length-cohort tiers, speculative decoding, the host KV tier, disaggregated
handoff, VLM requests, tensor/expert parallelism, and the staged and live
weight swaps.
"""

import logging
import os
import queue
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.device import DeviceLike, resolve_device
from areal_tpu_torch.gen.kv_pool import KVPool
from areal_tpu_torch.gen.sampling import root_key, sample_tokens_keyed, stream_keys
from areal_tpu_torch.models.hf import load_hf_params
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    Transformer,
    forward_decode,
    forward_prefill,
    init_kv_cache,
    init_params,
)
from areal_tpu_torch.ops.ragged_decode import ragged_supported
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
    trace_id: str = ""  # echoed on the wire
    # filled by the engine
    output_tokens: List[int] = field(default_factory=list)
    output_logprobs: List[float] = field(default_factory=list)
    output_versions: List[int] = field(default_factory=list)
    stop_reason: str = ""
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
        # the ragged kernel's shared-memory gate, once, at the widest window
        if not ragged_supported(max_seq_len, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_):
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds what the ragged decode "
                f"kernel's shared memory holds for {cfg.num_heads} q heads "
                f"over {cfg.num_kv_heads} kv heads of dim {cfg.head_dim_}"
            )
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.prompt_bucket = prompt_bucket
        self.decode_chunk = max(1, decode_chunk)
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
        # requests drained from `pending` whose prefill is in flight: an
        # abort_all landing meanwhile finishes them and bumps _abort_gen,
        # so the admission pass drops them instead of resurrecting them
        self._admitting: List[GenRequest] = []
        self._abort_gen = 0
        self._next_stream = 1
        # device copy of the decode state, rebuilt when admission or a
        # free dirties the host mirrors
        self._dev_state: Optional[Dict[str, torch.Tensor]] = None
        self._state_dirty = True
        self.stats = {
            "prefill_calls": 0,
            "prefill_tokens": 0,
            "decode_calls": 0,  # decode dispatches (one per chunk)
            "decode_steps": 0,  # forward_decode calls (chunk tokens each)
            "ragged_dispatches": 0,
            # pages the kernel read, summed over slots x steps
            "ragged_attended_pages": 0,
        }

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        if len(req.input_ids) + 1 >= self.max_seq_len:
            req.finish("length")
            return
        self.pending.put(req)

    def submit_batch(self, reqs: List[GenRequest]) -> None:
        """Enqueue a group contiguously so one admission pass sees it."""
        for req in reqs:
            self.submit(req)

    def active_count(self) -> int:
        with self._lock:
            return (sum(r is not None for r in self.slot_req)
                    + len(self._admitting) + self.pending.qsize())

    def abort_all(self, reason: str = "abort") -> int:
        """Finish every in-flight and queued request now; returns how many.
        Callbacks run after the lock is released (they may re-enter)."""
        to_finish: List[GenRequest] = []
        with self._lock:
            self._abort_gen += 1
            for s, req in enumerate(self.slot_req):
                if req is not None:
                    to_finish.append(req)
                    self.slot_req[s] = None
            to_finish.extend(self._admitting)
            self._admitting = []
            while True:
                try:
                    to_finish.append(self.pending.get_nowait())
                except queue.Empty:
                    break
            self._state_dirty = True
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

    def _admit(self) -> None:
        """Fill every free slot (lowest first) from the pending queue."""
        with self._lock:
            free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
            batch: List[GenRequest] = []
            while len(batch) < len(free):
                try:
                    batch.append(self.pending.get_nowait())
                except queue.Empty:
                    break
            self._admitting = list(batch)
            abort_gen = self._abort_gen
        if batch:
            self._admit_fresh_batch(list(zip(free, batch)), abort_gen)

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
            if self._abort_gen != abort_gen:
                return  # abort_all already finished these requests
            self._admitting = []
            for i, (s, req) in enumerate(admitted):
                self.slot_req[s] = req
                self.lengths[s] = plens[i]
                self.last_tokens[s] = toks[i]
                self.temperature[s] = req.temperature
                self.top_p[s] = req.top_p
                self.top_k[s] = req.top_k
                self.stream_ids[s] = streams[i]
            self._state_dirty = True
        for i, (s, req) in enumerate(admitted):
            self._record_token(s, int(toks[i]), float(logps[i]))

    def _record_token(self, s: int, tok: int, logp: float) -> None:
        """Deliver a prefill-sampled token; free the slot on a stop."""
        req = self.slot_req[s]
        if req is None:  # aborted between sampling and delivery
            return
        req.output_tokens.append(tok)
        req.output_logprobs.append(logp)
        req.output_versions.append(self.version)
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
        with self._lock:
            req = self.slot_req[s]
            self.slot_req[s] = None
            self._state_dirty = True
        if req is not None:
            req.finish(reason)

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

    def step(self, chunk: Optional[int] = None) -> int:
        """Admit pending prompts, then advance every active slot by up to
        `chunk` tokens in one dispatch.  Returns the tokens delivered
        (overshoot past a stop condition is discarded)."""
        self._admit()
        n = chunk or self.decode_chunk
        with self._lock:
            active = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
            if not active:
                return 0
            if self._dev_state is None or self._state_dirty:
                self._sync_device_state()
            st = self._dev_state
        try:
            out = self._dispatch_ragged(st, n, active)
        except Exception:
            with self._lock:  # the device state may be half advanced
                self._dev_state = None
                self._state_dirty = True
            raise
        toks = out[0].astype(np.int64)  # [n, n_slots]
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
                k, reason = n, ""
                for j in range(n):
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
                self.lengths[s] = L + k
                self.last_tokens[s] = toks[k - 1, s]
                delivered += k
                if reason:
                    self.slot_req[s] = None
                    to_finish.append((req, reason))
            if to_finish:
                self._state_dirty = True
        for req, reason in to_finish:
            req.finish(reason)
        return delivered

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

    def load_weights(self, path: str, version: Optional[int] = None) -> int:
        """Swap weights, aborting in-flight generation first (clients
        resubmit, and the new prefill recomputes under the new policy).
        `path` is a checkpoint dir or a trainer's snapshot root (the newest
        `v{N}`, or exactly `v{version}` when that exists); without a
        `version` the snapshot's N is adopted, else the version advances by
        one.  Call from the thread that steps the engine.  Returns the new
        version."""
        aborted = self.abort_all("abort")
        if aborted:
            logger.info("aborted %d requests for a weight update", aborted)
        pinned = os.path.join(path, f"v{int(version)}") if version is not None else None
        if pinned is not None and os.path.isdir(pinned):
            path = pinned
        else:
            path, dir_version = self.resolve_ckpt_dir(path)
            if version is None:
                version = dir_version
        # the old weights serve on until the new ones have loaded: a failed
        # load raises and leaves the engine as it was
        model, _ = load_hf_params(path, self.model_config, self.device)
        self.model = model
        self.version = int(version) if version is not None else self.version + 1
        return self.version

    def generate_blocking(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Synchronous helper (tests, offline use): run until all finish."""
        for r in reqs:
            self.submit(r)
        while any(not r.stop_reason for r in reqs):
            if self.step() == 0 and self.active_count() == 0:
                break
        return reqs
