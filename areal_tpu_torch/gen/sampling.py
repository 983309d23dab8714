"""Batched token sampling with counter-keyed noise (the port of
`areal_tpu/gen/sampling.py` `sample_tokens_keyed`).

Temperature 0 is greedy; unrestricted rows (top_k <= 0 and top_p >= 1)
draw from the full-vocab categorical so the behaviour distribution matches
the reported full-vocab logprobs; restricted rows run top-k/top-p inside a
static `TOPK_WINDOW`-wide candidate window.  The logprob is the sampled
token's under the temperature-scaled, unmasked distribution.

Noise is a pure function of (key, column): each row's key comes from
(seed, stream id, cache position) through a 32-bit integer hash, and
categorical draws are Gumbel-max over hashed uniforms.  A row's draw so
depends on its own key and logits only, never on the batch shape (the
property the JAX sampler gets from per-row PRNG keys).  The bits differ
from JAX's threefry keys, so sampled streams match JAX in distribution,
not token for token; greedy rows match exactly.
"""

import torch

TOPK_WINDOW = 64
NEG_INF = -1e30

_M32 = 0xFFFFFFFF
_SALT_WINDOW = 1
_SALT_FULL = 2


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values in
    [0, 2^32); the multiplier stays below 2^31 so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Derive a key from `key` and integer `data` (both broadcast)."""
    if not torch.is_tensor(data):
        data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _mix32(key ^ _mix32((data.long() + 0x9E3779B9) & _M32))


def root_key(seed: int, device=None) -> torch.Tensor:
    """The engine's decode key for `seed` (a 0-dim int64 tensor)."""
    return fold_in(torch.tensor(seed & _M32, dtype=torch.int64, device=device), 0xD)


def stream_keys(root: torch.Tensor, streams: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Per-row keys fold(fold(root, stream), position): the sampled token
    at cache position p of stream s is a function of (seed, s, p) only."""
    return fold_in(fold_in(root, streams.long()), positions.long())


def _gumbel(keys: torch.Tensor, salt: int, n: int) -> torch.Tensor:
    """[S, n] f32 Gumbel noise, column j of row i a function of
    (keys[i], salt, j)."""
    cols = torch.arange(n, dtype=torch.int64, device=keys.device)
    h = fold_in(fold_in(keys, salt)[:, None], cols[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1), 24 bits
    return -torch.log(-torch.log(u))


def _masked_window(logits, temperature, top_k, top_p):
    """Temperature-scale, take the candidate window, apply top-k/top-p.
    Returns (scaled [S, V], masked window logits [S, W], window idx [S, W],
    greedy [S])."""
    V = logits.shape[-1]
    logits = logits.float()
    greedy = temperature <= 0.0
    safe_temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / safe_temp[:, None]
    window = min(TOPK_WINDOW, V)
    win_logits, win_idx = torch.topk(scaled, window, dim=-1)
    ranks = torch.arange(window, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, window, torch.clamp(top_k, max=window))
    keep = ranks < k[:, None]
    win_probs = torch.softmax(win_logits, dim=-1)
    cum = torch.cumsum(win_probs, dim=-1)
    keep &= (cum - win_probs) < top_p[:, None]  # keep the first token past p
    keep |= ranks == 0  # top_p = 0 means near-greedy, never mask everything
    masked = torch.where(keep, win_logits, NEG_INF)
    return scaled, masked, win_idx, greedy


def token_logprob(scaled: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    tok = scaled.gather(-1, tokens[:, None])[:, 0]
    return tok - torch.logsumexp(scaled, dim=-1)


def sample_tokens_keyed(
    logits: torch.Tensor,  # [S, V]
    keys: torch.Tensor,  # int64 [S] per-row keys (`stream_keys`)
    temperature: torch.Tensor,  # [S]; 0 = greedy
    top_k: torch.Tensor,  # int [S]; 0 = disabled
    top_p: torch.Tensor,  # [S]; 1.0 = disabled
):
    """Returns (tokens int64 [S], logprobs f32 [S])."""
    scaled, masked, win_idx, greedy = _masked_window(logits, temperature, top_k, top_p)
    choice = torch.argmax(masked + _gumbel(keys, _SALT_WINDOW, masked.shape[-1]), dim=-1)
    sampled = win_idx.gather(-1, choice[:, None])[:, 0]
    full = torch.argmax(scaled + _gumbel(keys, _SALT_FULL, scaled.shape[-1]), dim=-1)
    unrestricted = (top_k <= 0) & (top_p >= 1.0)
    sampled = torch.where(unrestricted, full, sampled)
    # greedy is the first maximal logit, as lax.top_k's first index
    tokens = torch.where(greedy, torch.argmax(scaled, dim=-1), sampled)
    return tokens, token_logprob(scaled, tokens)
