"""OPA builtins host registry — the burrego equivalent.

Rego policies compiled to wasm leave any builtin the compiler cannot inline
as a host call: the module's ``builtins()`` export declares a
``name → id`` map and the generated code invokes
``opa_builtin{0..4}(id, ctx, args...)`` expecting the host to supply the
implementation. The reference ships the burrego builtins set and banners
it in ``--long-version`` (the reference's src/cli.rs:7-21; SURVEY.md §2.2
burrego row). This module is that registry for this package: pure-Python
implementations over decoded JSON values, dispatched by wasm/opa.py.

Implemented families (the common Gatekeeper/Kubewarden surface): strings
(incl. sprintf), regex, glob, sets, json/base64/urlquery encoding, semver,
units, and time.now_ns. Errors raise ``BuiltinError`` — evaluation fails
loudly like burrego's host-callback errors, never silently undefined.
"""

from __future__ import annotations

import base64 as _b64
import json
import re
import time
import urllib.parse
from typing import Any, Callable


class BuiltinError(Exception):
    """A builtin received invalid arguments or failed to compute."""


def _expect_str(v: Any, builtin: str, pos: int) -> str:
    if not isinstance(v, str):
        raise BuiltinError(f"{builtin}: operand {pos} must be string, got {type(v).__name__}")
    return v


def _expect_num(v: Any, builtin: str, pos: int):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise BuiltinError(f"{builtin}: operand {pos} must be number, got {type(v).__name__}")
    return v


def _expect_arr(v: Any, builtin: str, pos: int) -> list:
    if not isinstance(v, list):
        raise BuiltinError(f"{builtin}: operand {pos} must be array, got {type(v).__name__}")
    return v


# ---------------------------------------------------------------------------
# sprintf — Go fmt verb subset (%v %s %d %f %x %o %b %e %g %t %% with
# width/precision/zero-pad flags), the verbs Gatekeeper templates use
# ---------------------------------------------------------------------------

_VERB_RE = re.compile(r"%([-+ 0#]*)(\d+)?(?:\.(\d+))?([vsdfxXoObeEgGtq%])")


def _go_repr(v: Any) -> str:
    """%v rendering, close to Go's fmt for JSON-shaped values."""
    if v is None:
        return "<nil>"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (list, dict)):
        return json.dumps(v, separators=(", ", ": "))
    return str(v)


def sprintf(fmt: Any, args: Any) -> str:
    fmt = _expect_str(fmt, "sprintf", 1)
    values = list(_expect_arr(args, "sprintf", 2))
    out: list[str] = []
    pos = 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%":
            out.append(ch)
            i += 1
            continue
        m = _VERB_RE.match(fmt, i)
        if not m:
            out.append(ch)
            i += 1
            continue
        flags, width, prec, verb = m.groups()
        i = m.end()
        if verb == "%":
            out.append("%")
            continue
        if pos >= len(values):
            out.append(f"%!{verb}(MISSING)")
            continue
        v = values[pos]
        pos += 1
        try:
            if verb == "t":
                s = "true" if v else "false"
            elif verb in "dxXoOb":
                n = int(_expect_num(v, "sprintf", pos))
                base = {"d": "d", "x": "x", "X": "X", "o": "o", "O": "o", "b": "b"}[verb]
                s = format(n, base)
                if verb == "O":
                    s = "0o" + s
            elif verb in "feEgG":
                n = float(_expect_num(v, "sprintf", pos))
                p = int(prec) if prec is not None else 6
                if verb == "f":
                    s = f"{n:.{p}f}"
                else:
                    s = format(n, f".{p}{verb}")
            elif verb == "q":
                s = json.dumps(str(v))
            elif verb == "s":
                s = v if isinstance(v, str) else _go_repr(v)
            else:  # %v
                s = _go_repr(v)
        except BuiltinError:
            s = f"%!{verb}({_go_repr(v)})"
        if prec is not None and verb == "s":
            s = s[: int(prec)]
        if width:
            w = int(width)
            if "-" in flags:
                s = s.ljust(w)
            elif "0" in flags and verb in "dxXoObfeEgG":
                neg = s.startswith("-")
                body = s[1:] if neg else s
                s = ("-" if neg else "") + body.rjust(w - (1 if neg else 0), "0")
            else:
                s = s.rjust(w)
        out.append(s)
    return "".join(out)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------


def _concat(delim: Any, coll: Any) -> str:
    delim = _expect_str(delim, "concat", 1)
    parts = [_expect_str(x, "concat", 2) for x in _expect_arr(coll, "concat", 2)]
    return delim.join(parts)


def _format_int(n: Any, base: Any) -> str:
    n = int(_expect_num(n, "format_int", 1))
    base = int(_expect_num(base, "format_int", 2))
    if base == 2:
        s = format(abs(n), "b")
    elif base == 8:
        s = format(abs(n), "o")
    elif base == 10:
        s = str(abs(n))
    elif base == 16:
        s = format(abs(n), "x")
    else:
        raise BuiltinError(f"format_int: unsupported base {base}")
    return ("-" if n < 0 else "") + s


def _substring(s: Any, start: Any, length: Any) -> str:
    s = _expect_str(s, "substring", 1)
    start = int(_expect_num(start, "substring", 2))
    length = int(_expect_num(length, "substring", 3))
    if start < 0:
        raise BuiltinError("substring: negative offset")
    return s[start:] if length < 0 else s[start : start + length]


def _trim_left(s: Any, cutset: Any) -> str:
    return _expect_str(s, "trim_left", 1).lstrip(_expect_str(cutset, "trim_left", 2))


def _trim_right(s: Any, cutset: Any) -> str:
    return _expect_str(s, "trim_right", 1).rstrip(_expect_str(cutset, "trim_right", 2))


def _trim_prefix(s: Any, prefix: Any) -> str:
    s = _expect_str(s, "trim_prefix", 1)
    prefix = _expect_str(prefix, "trim_prefix", 2)
    return s[len(prefix):] if s.startswith(prefix) else s


def _trim_suffix(s: Any, suffix: Any) -> str:
    s = _expect_str(s, "trim_suffix", 1)
    suffix = _expect_str(suffix, "trim_suffix", 2)
    return s[: len(s) - len(suffix)] if suffix and s.endswith(suffix) else s


# ---------------------------------------------------------------------------
# regex (RE2-flavored patterns; Python re is a superset — policies using
# RE2-only syntax behave identically, backreference patterns would be
# rejected by OPA's own compiler anyway)
# ---------------------------------------------------------------------------


def _compile_re(pattern: str, builtin: str) -> re.Pattern:
    try:
        return re.compile(pattern)
    except re.error as e:
        raise BuiltinError(f"{builtin}: invalid pattern {pattern!r}: {e}") from e


def _regex_match(pattern: Any, value: Any) -> bool:
    return bool(
        _compile_re(_expect_str(pattern, "regex.match", 1), "regex.match").search(
            _expect_str(value, "regex.match", 2)
        )
    )


def _regex_is_valid(pattern: Any) -> bool:
    if not isinstance(pattern, str):
        return False
    try:
        re.compile(pattern)
        return True
    except re.error:
        return False


def _regex_split(pattern: Any, value: Any) -> list[str]:
    return _compile_re(_expect_str(pattern, "regex.split", 1), "regex.split").split(
        _expect_str(value, "regex.split", 2)
    )


def _regex_find_n(pattern: Any, value: Any, n: Any) -> list[str]:
    n = int(_expect_num(n, "regex.find_n", 3))
    matches = _compile_re(
        _expect_str(pattern, "regex.find_n", 1), "regex.find_n"
    ).finditer(_expect_str(value, "regex.find_n", 2))
    # OPA returns the FULL match text regardless of capture groups
    flat = [m.group(0) for m in matches]
    return flat if n < 0 else flat[:n]


def _go_replacement_to_python(repl: str, compiled: re.Pattern) -> str:
    """Go/RE2 replacement syntax → Python re.sub replacement: ``$1`` /
    ``${name}`` are group references, ``$$`` is a literal ``$``, a lone
    ``$`` is literal text, and — Go Expand semantics — a reference to a
    group the pattern does not define expands to the EMPTY string rather
    than erroring."""

    def group_ref(name: str) -> str:
        if name.isdigit():
            return f"\\g<{name}>" if int(name) <= compiled.groups else ""
        return f"\\g<{name}>" if name in compiled.groupindex else ""

    out: list[str] = []
    i = 0
    n = len(repl)
    while i < n:
        c = repl[i]
        if c == "\\":
            out.append("\\\\")
            i += 1
            continue
        if c != "$":
            out.append(c)
            i += 1
            continue
        if i + 1 < n and repl[i + 1] == "$":
            out.append("$")
            i += 2
            continue
        if i + 1 < n and repl[i + 1] == "{":
            j = repl.find("}", i + 2)
            if j > 0:
                out.append(group_ref(repl[i + 2 : j]))
                i = j + 1
                continue
        j = i + 1
        while j < n and (repl[j].isalnum() or repl[j] == "_"):
            j += 1
        if j > i + 1:
            out.append(group_ref(repl[i + 1 : j]))
            i = j
            continue
        out.append("$")  # lone $: literal
        i += 1
    return "".join(out)


def _regex_replace(value: Any, pattern: Any, replacement: Any) -> str:
    compiled = _compile_re(
        _expect_str(pattern, "regex.replace", 2), "regex.replace"
    )
    try:
        return compiled.sub(
            _go_replacement_to_python(
                _expect_str(replacement, "regex.replace", 3), compiled
            ),
            _expect_str(value, "regex.replace", 1),
        )
    except re.error as e:
        raise BuiltinError(f"regex.replace: {e}") from e


# ---------------------------------------------------------------------------
# glob (gobwas/glob semantics subset: * ? ** [..] {a,b} with delimiters)
# ---------------------------------------------------------------------------


def _glob_to_regex(pattern: str, delimiters: list[str]) -> str:
    delim = "".join(re.escape(d) for d in delimiters)
    any_nodelim = f"[^{delim}]*" if delim else ".*"
    one_nodelim = f"[^{delim}]" if delim else "."
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "*":
            if i + 1 < n and pattern[i + 1] == "*":
                out.append(".*")
                i += 2
            else:
                out.append(any_nodelim)
                i += 1
        elif c == "?":
            out.append(one_nodelim)
            i += 1
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j < 0:
                raise BuiltinError(f"glob.match: unterminated class in {pattern!r}")
            cls = pattern[i + 1 : j]
            if cls.startswith("!"):
                cls = "^" + cls[1:]
            out.append("[" + cls + "]")
            i = j + 1
        elif c == "{":
            j = pattern.find("}", i + 1)
            if j < 0:
                raise BuiltinError(f"glob.match: unterminated alternate in {pattern!r}")
            alts = pattern[i + 1 : j].split(",")
            out.append(
                "(?:" + "|".join(_glob_to_regex(a, delimiters)[2:-2] for a in alts) + ")"
            )
            i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return r"\A" + "".join(out) + r"\Z"


def _glob_match(pattern: Any, delimiters: Any, value: Any) -> bool:
    pattern = _expect_str(pattern, "glob.match", 1)
    if delimiters is None:
        delims = ["."]
    else:
        delims = [_expect_str(d, "glob.match", 2) for d in _expect_arr(delimiters, "glob.match", 2)]
    value = _expect_str(value, "glob.match", 3)
    try:
        return bool(re.match(_glob_to_regex(pattern, delims), value))
    except re.error as e:
        raise BuiltinError(f"glob.match: bad pattern {pattern!r}: {e}") from e


def _glob_quote_meta(pattern: Any) -> str:
    pattern = _expect_str(pattern, "glob.quote_meta", 1)
    return re.sub(r"([*?\[\]{}\\])", r"\\\1", pattern)


# ---------------------------------------------------------------------------
# sets (OPA sets cross the wasm boundary serialized as arrays)
# ---------------------------------------------------------------------------


def _freeze(v: Any):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def _dedup(items: list) -> list:
    seen = set()
    out = []
    for x in items:
        k = _freeze(x)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


def _set_intersection(sets: Any) -> list:
    sets = [_expect_arr(s, "intersection", 1) for s in _expect_arr(sets, "intersection", 1)]
    if not sets:
        return []
    keys = set(_freeze(x) for x in sets[0])
    for s in sets[1:]:
        keys &= set(_freeze(x) for x in s)
    return _dedup([x for x in sets[0] if _freeze(x) in keys])


def _set_union(sets: Any) -> list:
    sets = [_expect_arr(s, "union", 1) for s in _expect_arr(sets, "union", 1)]
    out: list = []
    for s in sets:
        out.extend(s)
    return _dedup(out)


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------


def _json_unmarshal(s: Any) -> Any:
    try:
        return json.loads(_expect_str(s, "json.unmarshal", 1))
    except ValueError as e:
        raise BuiltinError(f"json.unmarshal: {e}") from e


def _json_is_valid(s: Any) -> bool:
    if not isinstance(s, str):
        return False
    try:
        json.loads(s)
        return True
    except ValueError:
        return False


def _b64_decode(s: Any) -> str:
    try:
        return _b64.b64decode(_expect_str(s, "base64.decode", 1), validate=True).decode()
    except Exception as e:
        raise BuiltinError(f"base64.decode: {e}") from e


def _b64url_decode(s: Any) -> str:
    s = _expect_str(s, "base64url.decode", 1)
    pad = "=" * (-len(s) % 4)
    try:
        return _b64.urlsafe_b64decode(s + pad).decode()
    except Exception as e:
        raise BuiltinError(f"base64url.decode: {e}") from e


# ---------------------------------------------------------------------------
# semver
# ---------------------------------------------------------------------------

_SEMVER_RE = re.compile(
    r"^(0|[1-9]\d*)\.(0|[1-9]\d*)\.(0|[1-9]\d*)"
    r"(?:-((?:0|[1-9]\d*|\d*[A-Za-z-][0-9A-Za-z-]*)"
    r"(?:\.(?:0|[1-9]\d*|\d*[A-Za-z-][0-9A-Za-z-]*))*))?"
    r"(?:\+([0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?$"
)


def _semver_parse(s: str):
    m = _SEMVER_RE.match(s)
    if not m:
        raise BuiltinError(f"semver.compare: invalid semver {s!r}")
    major, minor, patch, pre, _build = m.groups()
    return (int(major), int(minor), int(patch)), pre


def _semver_compare(a: Any, b: Any) -> int:
    (va, pa) = _semver_parse(_expect_str(a, "semver.compare", 1))
    (vb, pb) = _semver_parse(_expect_str(b, "semver.compare", 2))
    if va != vb:
        return -1 if va < vb else 1
    if pa == pb:
        return 0
    if pa is None:
        return 1  # release > pre-release
    if pb is None:
        return -1

    def key(pre: str):
        parts = []
        for p in pre.split("."):
            parts.append((0, int(p), "") if p.isdigit() else (1, 0, p))
        return parts

    ka, kb = key(pa), key(pb)
    if ka == kb:
        return 0
    return -1 if ka < kb else 1


def _semver_is_valid(s: Any) -> bool:
    return isinstance(s, str) and bool(_SEMVER_RE.match(s))


# ---------------------------------------------------------------------------
# units (Kubernetes quantity suffixes — the Gatekeeper resource-limit case)
# ---------------------------------------------------------------------------

_BYTE_UNITS = {
    "": 1,
    "ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40, "pi": 2**50, "ei": 2**60,
    "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12, "p": 10**15, "e": 10**18,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12, "pb": 10**15, "eb": 10**18,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40, "pib": 2**50, "eib": 2**60,
}

_UNITS_RE = re.compile(r'^\s*"?\s*([0-9]+(?:\.[0-9]+)?)\s*([A-Za-z]*)\s*"?\s*$')


def _units_parse_bytes(s: Any):
    s = _expect_str(s, "units.parse_bytes", 1)
    m = _UNITS_RE.match(s)
    if not m:
        raise BuiltinError(f"units.parse_bytes: cannot parse {s!r}")
    num, unit = m.groups()
    mult = _BYTE_UNITS.get(unit.lower())
    if mult is None:
        raise BuiltinError(f"units.parse_bytes: unknown unit {unit!r}")
    val = float(num) * mult
    return int(val) if val.is_integer() else val


# SI suffixes are CASE-SENSITIVE ('m' milli vs 'M' mega — the K8s
# cpu-vs-memory distinction); binary suffixes are case-insensitive.
_SI_UNITS = {
    "": 1, "m": 1e-3, "k": 10**3, "K": 10**3, "M": 10**6, "G": 10**9,
    "T": 10**12, "P": 10**15, "E": 10**18,
}
_BINARY_UNITS = {
    "ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40, "pi": 2**50,
    "ei": 2**60,
}


def _units_parse(s: Any):
    """OPA units.parse: SI + binary suffixes, 'm' = milli (K8s CPU)."""
    s = _expect_str(s, "units.parse", 1)
    m = _UNITS_RE.match(s)
    if not m:
        raise BuiltinError(f"units.parse: cannot parse {s!r}")
    num, unit = m.groups()
    mult = _SI_UNITS.get(unit)
    if mult is None:
        mult = _BINARY_UNITS.get(unit.lower())
    if mult is None:
        raise BuiltinError(f"units.parse: unknown unit {unit!r}")
    val = float(num) * mult
    return int(val) if float(val).is_integer() else val


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

REGISTRY: dict[str, Callable[..., Any]] = {
    # strings
    "concat": _concat,
    "contains": lambda s, sub: _expect_str(sub, "contains", 2) in _expect_str(s, "contains", 1),
    "endswith": lambda s, suf: _expect_str(s, "endswith", 1).endswith(_expect_str(suf, "endswith", 2)),
    "startswith": lambda s, pre: _expect_str(s, "startswith", 1).startswith(_expect_str(pre, "startswith", 2)),
    "format_int": _format_int,
    "indexof": lambda s, sub: _expect_str(s, "indexof", 1).find(_expect_str(sub, "indexof", 2)),
    "lower": lambda s: _expect_str(s, "lower", 1).lower(),
    "upper": lambda s: _expect_str(s, "upper", 1).upper(),
    "replace": lambda s, old, new: _expect_str(s, "replace", 1).replace(
        _expect_str(old, "replace", 2), _expect_str(new, "replace", 3)
    ),
    "split": lambda s, d: _expect_str(s, "split", 1).split(_expect_str(d, "split", 2)),
    "sprintf": sprintf,
    "substring": _substring,
    "trim": lambda s, cutset: _expect_str(s, "trim", 1).strip(_expect_str(cutset, "trim", 2)),
    "trim_left": _trim_left,
    "trim_prefix": _trim_prefix,
    "trim_right": _trim_right,
    "trim_suffix": _trim_suffix,
    "trim_space": lambda s: _expect_str(s, "trim_space", 1).strip(),
    # regex
    "regex.match": _regex_match,
    "re_match": _regex_match,  # deprecated OPA alias, still emitted
    "regex.is_valid": _regex_is_valid,
    "regex.split": _regex_split,
    "regex.find_n": _regex_find_n,
    "regex.replace": _regex_replace,
    # glob
    "glob.match": _glob_match,
    "glob.quote_meta": _glob_quote_meta,
    # sets
    "intersection": _set_intersection,
    "union": _set_union,
    # encodings
    "json.marshal": lambda v: json.dumps(v, separators=(",", ":")),
    "json.unmarshal": _json_unmarshal,
    "json.is_valid": _json_is_valid,
    "base64.encode": lambda s: _b64.b64encode(_expect_str(s, "base64.encode", 1).encode()).decode(),
    "base64.decode": _b64_decode,
    "base64.is_valid": lambda s: isinstance(s, str)
    and bool(re.fullmatch(r"[A-Za-z0-9+/]*={0,2}", s))
    and len(s) % 4 == 0,
    "base64url.encode": lambda s: _b64.urlsafe_b64encode(
        _expect_str(s, "base64url.encode", 1).encode()
    ).decode(),
    "base64url.encode_no_pad": lambda s: _b64.urlsafe_b64encode(
        _expect_str(s, "base64url.encode_no_pad", 1).encode()
    ).decode().rstrip("="),
    "base64url.decode": _b64url_decode,
    "urlquery.encode": lambda s: urllib.parse.quote_plus(_expect_str(s, "urlquery.encode", 1)),
    "urlquery.decode": lambda s: urllib.parse.unquote_plus(_expect_str(s, "urlquery.decode", 1)),
    # semver
    "semver.compare": _semver_compare,
    "semver.is_valid": _semver_is_valid,
    # units
    "units.parse_bytes": _units_parse_bytes,
    "units.parse": _units_parse,
    # time
    "time.now_ns": lambda: time.time_ns(),
}


def get_builtins() -> dict[str, Callable[..., Any]]:
    """Name → implementation map (the burrego::get_builtins() analog used
    by the --long-version banner, the reference's src/cli.rs:7-21)."""
    return dict(REGISTRY)
