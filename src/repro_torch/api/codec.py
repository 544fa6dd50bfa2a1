"""Deterministic JSON codec for the API v1 envelopes.

``encode`` maps any envelope (or plain JSON-able value) to ONE canonical
byte sequence; ``decode`` inverts it.  Guarantees:

  * byte stability: ``encode(decode(encode(x))) == encode(x)`` — sorted
    keys, minimal separators, ASCII-escaped unicode, shortest-repr floats;
  * strict JSON on the wire: non-finite floats (NaN deadlines, infinite
    bounds) encode as a tagged object ``{"__float__": "nan"|"inf"|"-inf"}``
    instead of the non-standard ``NaN`` literal, so any JSON parser can
    read gateway traffic;
  * type fidelity: every dataclass carries a ``"__type__"`` tag and is
    reconstructed as the same class; sequences decode as tuples (the
    envelope field convention), so ``decode(encode(x)) == x`` for every
    envelope whose float fields are finite.  NaN fields (a no-deadline
    ``ChooseRequest``) decode back to NaN, where ``==`` is false by IEEE
    semantics — compare by ``encode`` bytes (``encode(decode(s)) == s``
    always holds) when identity over NaN payloads matters.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict

from repro_torch.api import types as T

_TYPES: Dict[str, type] = {cls.__name__: cls for cls in T.MESSAGE_TYPES}

_NONFINITE = {math.inf: "inf", -math.inf: "-inf"}

#: per message class: its wire name and (field, omit_default, default)
#: for each field, read once instead of through dataclasses.fields on
#: every encode (the serving edge encodes one envelope a request)
_FIELDS = {cls: (cls.__name__,
                 tuple((f.name, bool(f.metadata.get("omit_default")),
                        f.default) for f in dataclasses.fields(cls)))
           for cls in T.MESSAGE_TYPES}

_ENCODER = json.JSONEncoder(sort_keys=True, separators=(",", ":"),
                            ensure_ascii=True, allow_nan=False)
# the same encoder's C scanner, made once (``JSONEncoder.encode`` builds
# one a call); no circular-reference check: envelopes are trees
_C_ENCODE = None if json.encoder.c_make_encoder is None else \
    json.encoder.c_make_encoder(None, _ENCODER.default,
                                json.encoder.encode_basestring_ascii, None,
                                ":", ",", True, False, False)


def _to_jsonable(v: Any) -> Any:
    # exact types first: envelopes, floats, tuples and plain scalars;
    # anything else (float or int subclasses, dicts, unknown dataclasses)
    # takes the isinstance checks below, which raise the typed errors
    t = type(v)
    if t is float:
        if v - v == 0.0:                        # finite
            return v
        return {"__float__": "nan" if v != v else _NONFINITE[v]}
    spec = _FIELDS.get(t)
    if spec is not None:
        name, fields = spec
        out = {"__type__": name}
        for fname, omit, default in fields:
            val = getattr(v, fname)
            # fields marked omit_default are dropped from the wire when
            # they hold their default: new optional envelope fields can
            # be added without changing a single existing golden byte,
            # and decode reconstructs the default for legacy payloads
            if omit and val == default:
                continue
            tv = type(val)
            out[fname] = val if tv is str or tv is int or tv is bool \
                or val is None or (tv is float and val - val == 0.0) \
                else _to_jsonable(val)
        return out
    if t is tuple or t is list:
        return [_to_jsonable(x) for x in v]
    if t is str or t is int or t is bool or v is None:
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name not in _TYPES:
            raise TypeError(f"not an API v1 message type: {name}")
        out = {"__type__": name}
        for f in dataclasses.fields(v):
            val = getattr(v, f.name)
            if f.metadata.get("omit_default") and val == f.default:
                continue
            out[f.name] = _to_jsonable(val)
        return out
    if isinstance(v, float):
        if math.isnan(v):
            return {"__float__": "nan"}
        if math.isinf(v):
            return {"__float__": _NONFINITE[v]}
        return v
    if isinstance(v, (tuple, list)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x) for k, x in v.items()}
    if v is None or isinstance(v, (str, int, bool)):
        return v
    raise TypeError(f"unencodable value of type {type(v).__name__}: {v!r}")


def _from_jsonable(v: Any) -> Any:
    t = type(v)
    if t is dict:
        if "__float__" in v and len(v) == 1:
            return float(v["__float__"])        # "nan" / "inf" / "-inf"
        if "__type__" in v:
            cls = _TYPES[v["__type__"]]
            # JSON scalars (str, int, float, bool, None) decode as
            # themselves: only objects and arrays recurse
            kw = {k: _from_jsonable(x) if type(x) is dict
                  or type(x) is list else x
                  for k, x in v.items() if k != "__type__"}
            return cls(**kw)
        return {k: _from_jsonable(x) for k, x in v.items()}
    if t is list:
        return tuple([_from_jsonable(x) if type(x) is dict
                      or type(x) is list else x for x in v])
    return v


def encode(message: Any) -> str:
    """Canonical JSON text for one envelope (or nested JSON-able value)."""
    obj = _to_jsonable(message)
    if _C_ENCODE is None:
        return _ENCODER.encode(obj)
    return "".join(_C_ENCODE(obj, 0))


def decode(text: str) -> Any:
    """Inverse of ``encode``: reconstructs tagged dataclasses and tuples."""
    return _from_jsonable(json.loads(text))
