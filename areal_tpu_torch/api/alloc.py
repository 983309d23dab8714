"""Device-allocation DSL (the port's copy of `areal_tpu/api/alloc.py`): how
devices are split between generation and training.

The parser, `ParallelStrategy`, `HybridTrainStrategy` and `AllocationMode`
are the JAX package's, unchanged, and so is the dialect:

    d  data parallel            mesh axis "dp"
    f  fsdp / zero parallel     mesh axis "fsdp"
    t  tensor parallel          mesh axis "tp"
    s  sequence parallel        mesh axis "sp"
    c  context parallel         mesh axis "sp" (an alias of s on the mesh)
    p  pipeline parallel        no mesh axis
    e  expert parallel          mesh axis "ep"

Expression forms:

    "jax:d4t2"                     generation servers only
    "jax:d4t2+jax:d2f4"            disaggregated: gen devices + train devices
    "jax:d2t4|jax:d2t4"            colocated: the same devices serve both
    "jax:d4t2+eval"                gen + CPU eval procs
    "d2f2t2"                       train-only (e.g. SFT); backend defaults to jax
    "jax:(attn:d2c2|ffn:d2e2)"     MoE-folded hybrid train layout

The backend names ("jax", "sglang", "vllm"; "fsdp", "megatron") are words
of the dialect, kept so that one expression parses the same in both
packages; they select nothing in the port.  `parallel/mesh.py
mesh_from_alloc` maps a strategy onto the port's mesh.
"""

import enum
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GEN_BACKENDS = ("jax", "sglang", "vllm")
TRAIN_BACKENDS = ("jax", "fsdp", "megatron")

# dimension letter -> ParallelStrategy field
_DIM_FIELDS = {
    "d": "data_parallel_size",
    "f": "fsdp_parallel_size",
    "t": "tensor_parallel_size",
    "s": "sequence_parallel_size",
    "c": "context_parallel_size",
    "p": "pipeline_parallel_size",
    "e": "expert_parallel_size",
    "x": "expert_tensor_parallel_size",
}
_GEN_DIMS = frozenset("dtp")
_ATTN_DIMS = frozenset("dtscp")
_FFN_DIMS = frozenset("dtpex")


class AllocationType(enum.Enum):
    COLOCATE = 0
    DECOUPLED_TRAIN = 1
    LLM_SERVER_ONLY = 2
    DECOUPLED_EVAL = 3


class InvalidAllocationModeError(ValueError):
    pass


@dataclass
class ParallelStrategy:
    """N-D parallel layout; product of all axes is the slice's chip count.

    TPU-first: `fsdp` and `sequence` are first-class axes (they are distinct
    mesh axes for GSPMD), unlike the reference where ZeRO-sharding is implied
    by the backend (fsdp_engine.py) rather than the expression.
    """

    data_parallel_size: int = 1
    fsdp_parallel_size: int = 1
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    context_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    expert_tensor_parallel_size: int = 1

    # --- short aliases, mirroring reference property names ---
    @property
    def dp_size(self) -> int:
        return self.data_parallel_size

    @property
    def fsdp_size(self) -> int:
        return self.fsdp_parallel_size

    @property
    def tp_size(self) -> int:
        return self.tensor_parallel_size

    @property
    def sp_size(self) -> int:
        return self.sequence_parallel_size

    @property
    def cp_size(self) -> int:
        return self.context_parallel_size

    @property
    def pp_size(self) -> int:
        return self.pipeline_parallel_size

    @property
    def ep_size(self) -> int:
        return self.expert_parallel_size

    @property
    def etp_size(self) -> int:
        return self.expert_tensor_parallel_size

    @property
    def world_size(self) -> int:
        return (
            self.data_parallel_size
            * self.fsdp_parallel_size
            * self.tensor_parallel_size
            * self.sequence_parallel_size
            * self.context_parallel_size
            * self.pipeline_parallel_size
        )

    def __post_init__(self):
        for name, v in self.__dict__.items():
            if not (isinstance(v, int) and v >= 1):
                raise InvalidAllocationModeError(f"{name}={v!r} must be int >= 1")
        if self.sequence_parallel_size > 1 and self.context_parallel_size > 1:
            raise InvalidAllocationModeError(
                "s (Ulysses) and c (ring) both shard the sequence; pick one"
            )

    def validate_folded_experts(self):
        """For a *plain* (non-hybrid) section, expert axes fold into the dense
        world: ep*etp must divide it.  Hybrid sections instead treat ep/etp as
        chip axes of the ffn half (HybridTrainStrategy checks chip counts)."""
        if self.expert_parallel_size > 1:
            emp = self.expert_parallel_size * self.expert_tensor_parallel_size
            if self.world_size % emp != 0:
                raise InvalidAllocationModeError(
                    f"expert parallel size {emp} must divide world size "
                    f"{self.world_size}"
                )

    def __str__(self) -> str:
        out = []
        for letter, fname in _DIM_FIELDS.items():
            v = getattr(self, fname)
            if v != 1:
                out.append(f"{letter}{v}")
        return "".join(out) or "d1"

    def mesh_shape(self) -> Dict[str, int]:
        """Logical mesh axis sizes for this strategy (sp covers both s and c)."""
        return {
            "dp": self.data_parallel_size,
            "fsdp": self.fsdp_parallel_size,
            "sp": self.sequence_parallel_size * self.context_parallel_size,
            "tp": self.tensor_parallel_size,
        }


@dataclass
class HybridTrainStrategy:
    """MoE-folded layout: independent strategies for attention vs. expert FFN.

    Counterpart of the reference's `(attn:d2c2|ffn:d2e2)` grammar branch
    (alloc_mode.py:332-346).  Both halves must occupy the same chip count.
    """

    attn: ParallelStrategy
    ffn: ParallelStrategy

    def __post_init__(self):
        # In the ffn section expert axes are chip axes (Megatron MoE folding):
        # the same chips that serve (sp, cp, tp) for attention re-fold as
        # (ep, etp) for the expert FFN.
        ffn_chips = self.ffn.world_size * self.ffn.ep_size * self.ffn.etp_size
        if self.attn.world_size != ffn_chips:
            raise InvalidAllocationModeError(
                f"attn world size {self.attn.world_size} != ffn world size "
                f"{ffn_chips}"
            )

    @property
    def world_size(self) -> int:
        return self.attn.world_size


@dataclass
class AllocationMode:
    """Parsed allocation expression (reference: alloc_mode.py:245)."""

    type_: AllocationType
    gen: Optional[ParallelStrategy] = None
    train: Optional[ParallelStrategy] = None
    train_hybrid: Optional[HybridTrainStrategy] = None
    gen_backend: Optional[str] = None
    train_backend: Optional[str] = None

    @property
    def gen_instance_size(self) -> int:
        """Chips per generation server instance (everything but its dp axis)."""
        if self.gen is None:
            return 0
        return self.gen.world_size // self.gen.data_parallel_size

    @property
    def gen_world_size(self) -> int:
        return self.gen.world_size if self.gen is not None else 0

    @property
    def train_world_size(self) -> int:
        if self.train is not None:
            return self.train.world_size
        if self.train_hybrid is not None:
            return self.train_hybrid.world_size
        return 0

    @property
    def world_size(self) -> int:
        if self.type_ == AllocationType.COLOCATE and self.gen is not None:
            return max(self.gen_world_size, self.train_world_size)
        return self.gen_world_size + self.train_world_size

    @classmethod
    def from_str(cls, s: str) -> "AllocationMode":
        return _Parser(s).parse()


class _Parser:
    """Recursive descent over:

    expr          := section (("+" | "|") section)*
    section       := [backend ":"] (dims | hybrid) | "eval" | "cpu"
    hybrid        := "(" "attn" ":" dims "|" "ffn" ":" dims ")"
    dims          := (DIM_LETTER NUMBER)+
    """

    _TOKEN_RE = re.compile(
        r"\s*(?:(?P<name>[A-Za-z_][A-Za-z0-9_]*)|(?P<num>[0-9]+)|(?P<sym>[+|():.]))"
    )

    def __init__(self, text: str):
        self.text = text.strip()
        self.tokens = self._lex(self.text)
        self.pos = 0

    def _lex(self, text: str) -> List[Tuple[str, str]]:
        tokens, i = [], 0
        while i < len(text):
            m = self._TOKEN_RE.match(text, i)
            if not m or m.end() == i:
                raise InvalidAllocationModeError(
                    f"bad character at {i} in allocation expr {text!r}"
                )
            for kind in ("name", "num", "sym"):
                if m.group(kind) is not None:
                    tokens.append((kind, m.group(kind)))
            i = m.end()
        return tokens

    def _peek(self, k: int = 0):
        return self.tokens[self.pos + k] if self.pos + k < len(self.tokens) else None

    def _next(self):
        tok = self._peek()
        if tok is None:
            raise InvalidAllocationModeError(f"unexpected end of expr {self.text!r}")
        self.pos += 1
        return tok

    def _expect(self, kind: str, value: Optional[str] = None):
        tok = self._next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise InvalidAllocationModeError(
                f"expected {value or kind}, got {tok[1]!r} in {self.text!r}"
            )
        return tok

    # --- grammar ---
    def parse(self) -> AllocationMode:
        if not self.tokens:
            raise InvalidAllocationModeError("empty allocation expression")
        sections = [self._section()]
        seps = []
        while self._peek() is not None:
            kind, sym = self._next()
            if kind != "sym" or sym not in "+|":
                raise InvalidAllocationModeError(
                    f"expected '+' or '|' between sections, got {sym!r}"
                )
            seps.append(sym)
            sections.append(self._section())
        return self._assemble(sections, seps)

    def _section(self):
        tok = self._peek()
        if tok and tok[0] == "name" and tok[1] in ("eval", "cpu"):
            self._next()
            return ("eval", None, None)
        backend = None
        if (
            tok
            and tok[0] == "name"
            and tok[1] in GEN_BACKENDS + TRAIN_BACKENDS
            and self._peek(1) is not None
            and self._peek(1)[0] == "sym"
            and self._peek(1)[1] in ":."
        ):
            backend = self._next()[1]
            self._next()  # ":" or legacy "."
        nxt = self._peek()
        if nxt is not None and nxt[0] == "sym" and nxt[1] == "(":
            return ("hybrid", backend, self._hybrid())
        return ("plain", backend, self._dims(allowed=frozenset(_DIM_FIELDS)))

    def _hybrid(self) -> HybridTrainStrategy:
        self._expect("sym", "(")
        self._expect("name", "attn")
        self._expect("sym", ":")
        attn = self._dims(allowed=_ATTN_DIMS)
        self._expect("sym", "|")
        self._expect("name", "ffn")
        self._expect("sym", ":")
        ffn = self._dims(allowed=_FFN_DIMS)
        self._expect("sym", ")")
        return HybridTrainStrategy(attn=attn, ffn=ffn)

    _DIMS_RE = re.compile(r"([a-z])([1-9][0-9]*)")

    def _dims(self, allowed: frozenset) -> ParallelStrategy:
        # a dims run like "d4t2" lexes as a single name token (letters+digits)
        tok = self._peek()
        if tok is None or tok[0] != "name":
            raise InvalidAllocationModeError(
                f"expected parallel dims, got {tok and tok[1]!r} in {self.text!r}"
            )
        text = self._next()[1]
        pairs = self._DIMS_RE.findall(text)
        if "".join(l + n for l, n in pairs) != text or not pairs:
            raise InvalidAllocationModeError(
                f"malformed parallel dims {text!r} in {self.text!r}"
            )
        kwargs: Dict[str, int] = {}
        for letter, num in pairs:
            if letter not in _DIM_FIELDS:
                raise InvalidAllocationModeError(
                    f"unknown parallel dim {letter!r} in {self.text!r}"
                )
            if letter not in allowed:
                raise InvalidAllocationModeError(
                    f"dim {letter!r} not allowed in this section of {self.text!r}"
                )
            fname = _DIM_FIELDS[letter]
            if fname in kwargs:
                raise InvalidAllocationModeError(f"duplicate dim {letter!r}")
            kwargs[fname] = int(num)
        return ParallelStrategy(**kwargs)

    def _assemble(self, sections, seps) -> AllocationMode:
        if len(sections) > 2:
            raise InvalidAllocationModeError(
                f"at most two sections supported, got {len(sections)}"
            )

        def is_gen(sec) -> bool:
            return sec[1] in ("jax", "sglang", "vllm") and sec[1] is not None

        if len(sections) == 1:
            kind, backend, strat = sections[0]
            if kind == "eval":
                raise InvalidAllocationModeError("bare 'eval' is not an allocation")
            if kind == "hybrid":
                return AllocationMode(
                    type_=AllocationType.COLOCATE,
                    train_hybrid=strat,
                    train_backend=backend or "jax",
                )
            if is_gen(sections[0]) and backend in GEN_BACKENDS and backend != "jax":
                # sglang:d4t2 / vllm:d2t4 — inference-only
                self._check_gen(strat)
                return AllocationMode(
                    type_=AllocationType.LLM_SERVER_ONLY,
                    gen=strat,
                    gen_backend=backend,
                )
            if backend == "jax":
                # ambiguous: "jax:d4t2" alone means an LLM-server-only slice
                self._check_gen(strat)
                return AllocationMode(
                    type_=AllocationType.LLM_SERVER_ONLY, gen=strat, gen_backend="jax"
                )
            # bare dims -> train-only colocate (SFT-style)
            strat.validate_folded_experts()
            return AllocationMode(
                type_=AllocationType.COLOCATE,
                train=strat,
                train_backend=backend or "jax",
            )

        (k1, b1, s1), (k2, b2, s2) = sections
        sep = seps[0]
        if k2 == "eval":
            if k1 != "plain" or b1 not in GEN_BACKENDS:
                raise InvalidAllocationModeError(
                    "eval must follow a generation section"
                )
            self._check_gen(s1)
            return AllocationMode(
                type_=AllocationType.DECOUPLED_EVAL, gen=s1, gen_backend=b1 or "jax"
            )
        if k1 == "eval":
            raise InvalidAllocationModeError("eval section must come last")
        if b1 is None or b1 not in GEN_BACKENDS:
            raise InvalidAllocationModeError(
                f"first section of a two-part expr must name a gen backend "
                f"({'/'.join(GEN_BACKENDS)}): {self.text!r}"
            )
        self._check_gen(s1)
        if b2 is not None and b2 not in TRAIN_BACKENDS:
            raise InvalidAllocationModeError(
                f"second section backend must be a train backend "
                f"({'/'.join(TRAIN_BACKENDS)}), got {b2!r}"
            )
        type_ = (
            AllocationType.DECOUPLED_TRAIN if sep == "+" else AllocationType.COLOCATE
        )
        mode = AllocationMode(type_=type_, gen=s1, gen_backend=b1)
        if k2 == "hybrid":
            mode.train_hybrid = s2
        else:
            s2.validate_folded_experts()
            mode.train = s2
        mode.train_backend = b2 or "jax"
        return mode

    @staticmethod
    def _check_gen(strat: ParallelStrategy):
        for letter, fname in _DIM_FIELDS.items():
            if letter not in _GEN_DIMS and getattr(strat, fname) != 1:
                raise InvalidAllocationModeError(
                    f"generation sections only support dims d/t/p, got {letter!r}"
                )
