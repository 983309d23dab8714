"""Math answer extraction and verification (the port's copy of
`areal_tpu/reward/math_parser.py`, which imports no framework, without
`math_verify_reward`, which no port caller uses).

Behavioral counterpart of the reference's rule-based math verifier
(areal/reward/math_parser.py:219 strip_string, :360 extract_answer, :495
math_equal, backed by vendored latex2sympy in evaluation/): extract the
model's final answer, normalise latex/number/unit formatting, and compare —
string match, then numeric (with the reference's percentage tolerance),
then element-wise for tuples/intervals/matrices, then sympy symbolic
equivalence.  antlr/latex2sympy is not available in this image, so latex is
lowered to sympy-parsable text by an in-repo rewriter instead of a vendored
grammar.

Reward honesty: `extract_answer` used as a REWARD
signal is strict — it requires an explicit answer marker (\\boxed{},
"the answer is", "####", "$ ... $. I hope") and returns None otherwise.
The permissive last-number fallback the reference enables for offline eval
(`use_last_number=True`) exists behind `strict=False` only; RL reward
functions never use it, so emitting any number cannot farm reward.

Runs inside the reward process pool (api/reward.py), so sympy hangs are
bounded by the pool timeout rather than an in-process alarm.
"""

import re
from typing import List, Optional

# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------


def _find_boxed(text: str) -> Optional[str]:
    """Last \\boxed{...} / \\fbox{...} content, brace-balanced."""
    idx = max(text.rfind("\\boxed"), text.rfind("\\fbox"))
    if idx < 0:
        return None
    brace = text.find("{", idx)
    if brace < 0:
        # \boxed 42 form
        m = re.match(r"\\boxed\s+(\S+)", text[idx:])
        return m.group(1) if m else None
    depth = 0
    for i in range(brace, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[brace + 1 : i]
    return None


_ANSWER_PATTERNS = [
    r"(?:final answer|the answer)\s*(?:is\s*:?|:)\s*([^\n]+)",
    r"####\s*([^\n]+)",
    # bare "Answer: 042" lines (AIME-style submissions)
    r"^answer\s*:\s*([^\n]+)",
    r"\nanswer\s*:\s*([^\n]+)",
]


def extract_answer(text: str, strict: bool = True) -> Optional[str]:
    """Pull the final answer out of a model completion.

    strict=True (reward path): only explicit answer markers count.
    strict=False (offline eval): additionally falls back to the last number
    in the text (reference extract_answer's use_last_number=True)."""
    if not text:
        return None
    # minerva-style "final answer is $X$. I hope it is correct."
    if "final answer is $" in text and "$. I hope" in text:
        frag = text.split("final answer is $", 1)[1].split("$. I hope", 1)[0]
        return frag.strip()
    boxed = _find_boxed(text)
    if boxed is not None:
        return boxed.strip()
    low = text.lower()
    for pat in _ANSWER_PATTERNS:
        matches = list(re.finditer(pat, low))
        if matches:
            m = matches[-1]
            ans = text[m.start(1) : m.end(1)].strip()
            # trim trailing prose after the expression: "is 42. Done" -> 42
            ans = re.split(r"(?<=[\d\w)\]}])\.\s", ans)[0]
            return ans.rstrip(".").strip()
    if not strict:
        nums = re.findall(r"-?\d[\d,]*(?:\.\d+)?", text)
        return nums[-1].replace(",", "") if nums else None
    return None


# --------------------------------------------------------------------------
# normalisation
# --------------------------------------------------------------------------

_WORD_NUMBERS = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "ten": "10", "eleven": "11", "twelve": "12",
}

# unit words stripped when attached to a number (reference strip_string's
# unit_texts table role); conservative: only straightforward count units
_UNIT_WORDS = [
    "degrees?", "dollars?", "cents?", "percent", "points?", "units?",
    "meters?", "metres?", "miles?", "feet", "foot", "inch(?:es)?",
    "centimeters?", "kilometers?", "km", "cm", "mm", "kg", "grams?",
    "pounds?", "ounces?", "liters?", "litres?", "ml",
    "seconds?", "minutes?", "hours?", "days?", "weeks?", "months?",
    "years?", "mph", "km/h", "sq", "square", "cubic", "per",
]
_UNIT_RE = re.compile(
    r"(?<=[\d\s.)])\s*\\?(?:" + "|".join(_UNIT_WORDS) + r")\b\.?", re.IGNORECASE
)

_LATEX_SUBS = [
    (r"\\left|\\right", ""),
    (r"\\!|\\,|\\;|\\:|\\ ", ""),
    (r"~", " "),
    (r"\\mathrm\{([^{}]*)\}", r"\1"),
    (r"\\mathbf\{([^{}]*)\}", r"\1"),
    (r"\\mbox\{[^{}]*\}$", ""),
    (r"\\mbox\{([^{}]*)\}", r"\1"),
    (r"\\\$|\$", ""),
    (r"\\%|%", ""),
    (r"\^\{?\\circ\}?", ""),
    (r"\\degree", ""),
    (r"\\dfrac|\\tfrac|\\cfrac", r"\\frac"),
    (r"\\cdot|\\times", "*"),
    (r"\\div", "/"),
    (r"\\pi\b", "pi"),
    (r"\\infty|infinity|\binf\b", "oo"),
    (r"\\ne(?:q)?\b", "!="),
    (r"\\le(?:q)?\b", "<="),
    (r"\\ge(?:q)?\b", ">="),
    (r"\\approx", "="),
    (r"\\begin\{array\}\{[^{}]*\}", r"\\begin{pmatrix}"),
    (r"\\end\{array\}", r"\\end{pmatrix}"),
    (r"bmatrix|vmatrix|Bmatrix", "pmatrix"),
    (r"\\in\b", "="),
]


def _fix_fracs(s: str) -> str:
    """All \\frac spellings -> ((a)/(b)): braced (one nesting level deep),
    half-braced (\\frac{a}b), and bare two-token (\\frac12, \\frac1x)
    forms.  Innermost fracs resolve first, so \\frac{\\frac{1}{2}}{3}
    converges over iterations."""
    token = r"(\{(?:[^{}]|\{[^{}]*\})*\}|[^\s{}\\])"
    pat = re.compile(r"\\frac\s*" + token + r"\s*" + token)
    for _ in range(10):  # bounded fixpoint
        m = pat.search(s)
        if not m:
            break
        num, den = (
            g[1:-1] if g.startswith("{") and g.endswith("}") else g
            for g in m.groups()
        )
        s = s[: m.start()] + f"(({num})/({den}))" + s[m.end() :]
    return s


def _fix_binom(s: str) -> str:
    """\\binom{n}{k} / \\dbinom -> binomial(n, k) (sympy-parseable)."""
    return re.sub(
        r"\\d?binom\s*\{([^{}]*)\}\s*\{([^{}]*)\}", r"binomial(\1,\2)", s
    )


def _fix_sqrt(s: str) -> str:
    s = re.sub(r"\\sqrt\s*\{([^{}]*)\}", r"sqrt(\1)", s)
    s = re.sub(r"\\sqrt\s*(\w)", r"sqrt(\1)", s)
    return s


def _fix_mixed_number(s: str) -> str:
    """3\\frac{1}{2} and '3 1/2' style mixed numbers -> (3+(1)/(2))."""
    m = re.fullmatch(r"(-?\d+)\s*\(\((\d+)\)/\((\d+)\)\)", s)
    if m:
        whole, num, den = m.groups()
        sign = "-" if whole.startswith("-") else "+"
        return f"({whole}{sign}({num})/({den}))"
    return s


def normalize_answer(ans: str) -> str:
    s = str(ans).strip().replace("\n", "")
    s = s.rstrip(".").rstrip("/")
    s = re.sub(r"\\text\s*\{([^{}]*)\}", r"\1", s)
    s = _UNIT_RE.sub("", s)
    for pat, rep in _LATEX_SUBS:
        s = re.sub(pat, rep, s)
    for w, d in _WORD_NUMBERS.items():
        s = re.sub(rf"\b{w}\b", d, s, flags=re.IGNORECASE)
    s = _fix_binom(s)  # before fracs: brace structure must survive
    s = _fix_sqrt(s)  # before fracs: \frac{\sqrt{3}}{3} loses inner braces
    s = _fix_fracs(s)
    # "x = 5" / "k=5" style prefixes: keep the value side.  lhs must be a
    # bare variable name — '<='/'>=' from the \le/\ge rewrites must NOT
    # count, else inequalities collapse to their number
    if s.count("=") == 1:
        lhs, rhs = s.split("=")
        lhs = lhs.strip()
        if len(lhs) <= 2 and lhs.isalnum() and rhs.strip():
            s = rhs
    s = s.replace("^", "**")
    # whitespace first so '(1, 234)' and '(1,234)' normalise identically,
    # THEN thousands separators inside digit groups — ambiguous 3-digit
    # tuples resolve to the same reading on both sides of a comparison
    s = re.sub(r"\s+", "", s)
    s = re.sub(r"(\d),(?=\d{3}(\D|$))", r"\1", s)
    s = s.replace("{", "(").replace("}", ")")
    s = _fix_mixed_number(s)
    # ".5" -> "0.5", "2.0" -> "2"
    s = re.sub(r"(?<![\d.])\.(\d)", r"0.\1", s)
    s = re.sub(r"(\d+)\.0+(?=\D|$)", r"\1", s)
    # drop a single unbalanced paren at either end; never touch balanced
    # ones, and never touch half-open intervals like '[1/2, 1)' where the
    # 'unbalanced' paren is matched by a square bracket
    if "[" not in s and "]" not in s:
        if s.count("(") > s.count(")"):
            if s.endswith("("):
                s = s[:-1]
            elif s.startswith("("):
                s = s[1:]
        elif s.count(")") > s.count("("):
            if s.startswith(")"):
                s = s[1:]
            elif s.endswith(")"):
                s = s[:-1]
    return s.lower()


# --------------------------------------------------------------------------
# comparison
# --------------------------------------------------------------------------


def _to_number(s: str) -> Optional[float]:
    try:
        return float(s)
    except (ValueError, TypeError):
        pass
    m = re.fullmatch(r"\(*\(?(-?[\d\.]+)\)?/\(?(-?[\d\.]+)\)?\)*", s)
    if m:
        try:
            return float(m.group(1)) / float(m.group(2))
        except (ValueError, ZeroDivisionError):
            return None
    return None


def _split_top_level(s: str) -> Optional[List[str]]:
    """'(a,b,c)' / '[a,b)' -> top-level comma split, else None."""
    if len(s) < 2 or s[0] not in "([" or s[-1] not in ")]":
        return None
    inner = s[1:-1]
    parts, depth, cur = [], 0, ""
    for c in inner:
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        if c == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += c
    parts.append(cur)
    return parts if len(parts) > 1 else None


def _pmatrix_rows(s: str) -> Optional[List[List[str]]]:
    m = re.fullmatch(r"\\begin\(pmatrix\)(.*)\\end\(pmatrix\)", s)
    if not m:
        return None
    return [row.split("&") for row in m.group(1).split("\\\\") if row]


def _numeric_eval(s: str) -> Optional[float]:
    """Float value of a closed-form expression (sqrt/pi/binomial/fractions),
    None when it stays symbolic (free variables) or fails to parse."""
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    try:
        e = parse_expr(
            s,
            transformations=standard_transformations
            + (implicit_multiplication_application,),
            evaluate=True,
        )
        if e.free_symbols:
            return None
        v = sympy.N(e)
        if v.is_real is False:
            return None
        return float(v)
    except Exception:  # noqa: BLE001 — not numerically evaluable
        return None


def _sympy_equal(p: str, t: str) -> bool:
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    transforms = standard_transformations + (implicit_multiplication_application,)

    def parse(s):
        return parse_expr(s, transformations=transforms, evaluate=True)

    try:
        pe, te = parse(p), parse(t)
    except Exception:  # noqa: BLE001 — unparseable => not equal
        return False
    try:
        if pe == te:
            return True
        diff = sympy.simplify(pe - te)
        return diff == 0
    except Exception:  # noqa: BLE001
        return False


def math_equal(
    pred: str,
    target: str,
    rel_tol: float = 1e-4,
    include_percentage: bool = True,
    depth: int = 0,
) -> bool:
    """Graded equivalence (reference math_parser.math_equal:495): exact
    string -> numeric (with /100, x100 percentage forms) -> element-wise
    tuples/intervals/matrices -> equation sides -> sympy symbolic."""
    if pred is None or target is None:
        return False
    p, t = normalize_answer(str(pred)), normalize_answer(str(target))
    if p == t:
        return True

    pn, tn = _to_number(p), _to_number(t)
    if pn is not None and tn is not None:
        candidates = [tn]
        if include_percentage:
            candidates = [tn / 100.0, tn, tn * 100.0]
        return any(
            abs(pn - c) <= rel_tol * max(1.0, abs(c)) for c in candidates
        )
    if (pn is None) != (tn is None):
        # decimal vs closed form ("1.618..." vs (1+sqrt(5))/2): evaluate the
        # symbolic side numerically and compare under the same tolerance —
        # with the same percentage candidates as the numeric-numeric branch,
        # so equivalent (pred, target) pairs score identically either way
        sym, num = (t, pn) if pn is not None else (p, tn)
        val = _numeric_eval(sym)
        if val is not None:
            candidates = [val]
            if include_percentage:
                candidates = [val / 100.0, val, val * 100.0]
            return any(
                abs(num - c) <= rel_tol * max(1.0, abs(c))
                for c in candidates
            )

    if depth < 3:
        # tuples / intervals / coordinate pairs: element-wise
        pp, tt = _split_top_level(p), _split_top_level(t)
        if pp is not None and tt is not None:
            if len(pp) != len(tt) or p[0] != t[0] or p[-1] != t[-1]:
                return False
            return all(
                math_equal(a, b, rel_tol, include_percentage, depth + 1)
                for a, b in zip(pp, tt)
            )
        # matrices: element-wise over rows
        pm, tm = _pmatrix_rows(p), _pmatrix_rows(t)
        if pm is not None and tm is not None:
            if len(pm) != len(tm):
                return False
            return all(
                len(pr) == len(tr)
                and all(
                    math_equal(a, b, rel_tol, include_percentage, depth + 1)
                    for a, b in zip(pr, tr)
                )
                for pr, tr in zip(pm, tm)
            )
        # single equations: compare both sides
        if p.count("=") == 1 and t.count("=") == 1:
            pl, pr = p.split("=")
            tl, tr = t.split("=")
            return math_equal(
                pl, tl, rel_tol, include_percentage, depth + 1
            ) and math_equal(pr, tr, rel_tol, include_percentage, depth + 1)

    return _sympy_equal(p, t)


# --------------------------------------------------------------------------
# reward functions (signature: prompt, completion, prompt_ids, completion_ids,
# **data -> float; reference: areal/reward usage in workflows)
# --------------------------------------------------------------------------


def gsm8k_reward_fn(prompt, completions, prompt_ids, completion_ids, answer, **kw):
    pred = extract_answer(completions, strict=True)
    return float(pred is not None and math_equal(pred, answer))
