"""Character-level JSON / JSON-schema acceptance automaton.

A nondeterministic pushdown automaton over characters: the machine holds a
set of alternative configurations (stacks of frames); ``allowed_chars()``
returns every character some configuration can consume next, ``advance(ch)``
consumes a character. Schema constraints (the practical subset the reference
exercised through PSE: object properties/required/additionalProperties,
arrays, enums, string/number/integer/boolean/null, oneOf — reference
state_machine/sub_states/structured_output.py + tool_call.py usage) are
compiled into the frames.

This runs host-side; pie_tpu/structured/token_masks.py lifts it to per-step
token masks applied to device logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

DIGITS = "0123456789"
WS = " \n\t"
# characters allowed inside free strings (mask vocabulary is the real
# constraint; control chars and the quote/backslash handled separately)
MAX_FREE_STRING = 4096
MAX_WS_RUN = 2


class Frame:
    """One stack frame. Subclasses implement:
    - step(ch, stack_below) -> list of (consumed, new_frames_or_None) moves
    - allowed() -> iterable of chars consumable directly
    - poppable() -> True if the frame may end WITHOUT consuming (the char is
      then offered to the frame below)
    """

    def allowed(self) -> Iterable[str]:
        return ()

    def poppable(self) -> bool:
        return False

    def consume(self, ch: str) -> Optional[list["Frame"]]:
        """Returns replacement frames for THIS frame (possibly several,
        pushed in order: last element = top of stack), or None if ch is not
        consumable."""
        return None


def _freeze(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class Lit(Frame):
    """Fixed remaining text (e.g. 'rue' after 't')."""

    rest: str

    def allowed(self):
        return (self.rest[0],) if self.rest else ()

    def poppable(self):
        return not self.rest

    def consume(self, ch):
        if self.rest and ch == self.rest[0]:
            rem = self.rest[1:]
            return [Lit(rem)] if rem else []
        return None


@dataclasses.dataclass(frozen=True)
class Ws(Frame):
    """Optional whitespace (bounded run)."""

    budget: int = MAX_WS_RUN

    def allowed(self):
        return WS if self.budget > 0 else ()

    def poppable(self):
        return True

    def consume(self, ch):
        if self.budget > 0 and ch in WS:
            return [Ws(self.budget - 1)]
        return None


@dataclasses.dataclass(frozen=True)
class FreeString(Frame):
    """Inside '"' ... '"' with arbitrary content; supports escapes."""

    in_escape: bool = False
    remaining: int = MAX_FREE_STRING

    def allowed(self):
        if self.in_escape:
            return '"\\/bfnrtu'
        return ("\x00",)  # sentinel: "any string char" (expanded by masker)

    def poppable(self):
        return False

    def consume(self, ch):
        if self.in_escape:
            if ch in '"\\/bfnrtu':
                return [FreeString(False, self.remaining - 1)]
            return None
        if ch == '"':
            return []
        if ch == "\\":
            return [FreeString(True, self.remaining)]
        if ch in "\n\r" or self.remaining <= 0:
            return None
        return [FreeString(False, self.remaining - 1)]


@dataclasses.dataclass(frozen=True)
class FixedString(Frame):
    """String constrained to one of ``options`` (enum values / property
    names); tracks the emitted prefix."""

    options: tuple[str, ...]
    prefix: str = ""

    def allowed(self):
        chars = set()
        for o in self.options:
            if o.startswith(self.prefix):
                if len(o) > len(self.prefix):
                    chars.add(o[len(self.prefix)])
                else:
                    chars.add('"')
        return chars

    def consume(self, ch):
        if ch == '"' and any(o == self.prefix for o in self.options):
            return []
        nxt = self.prefix + ch
        if any(o.startswith(nxt) for o in self.options):
            return [FixedString(self.options, nxt)]
        return None


@dataclasses.dataclass(frozen=True)
class Number(Frame):
    """JSON number; phases: s(start) m(minus-seen) i(int) d(frac-start)
    f(frac) e(exp-start) g(exp-sign-seen) x(exp)."""

    phase: str = "s"
    integer_only: bool = False

    def allowed(self):
        p = self.phase
        if p == "s":
            return "-" + DIGITS
        if p == "m":
            return DIGITS
        if p == "i":
            out = DIGITS
            if not self.integer_only:
                out += ".e"
            return out
        if p == "d":
            return DIGITS
        if p == "f":
            return DIGITS + "e"
        if p == "e":
            return "+-" + DIGITS
        if p == "g":
            return DIGITS
        if p == "x":
            return DIGITS
        return ()

    def poppable(self):
        return self.phase in ("i", "f", "x")

    def consume(self, ch):
        p = self.phase
        io = self.integer_only

        def nxt(phase):
            return [Number(phase, io)]

        if p == "s":
            if ch == "-":
                return nxt("m")
            if ch in DIGITS:
                return nxt("i")
        elif p == "m":
            if ch in DIGITS:
                return nxt("i")
        elif p == "i":
            if ch in DIGITS:
                return nxt("i")
            if not io and ch == ".":
                return nxt("d")
            if not io and ch == "e":
                return nxt("e")
        elif p == "d":
            if ch in DIGITS:
                return nxt("f")
        elif p == "f":
            if ch in DIGITS:
                return nxt("f")
            if ch == "e":
                return nxt("e")
        elif p == "e":
            if ch in "+-":
                return nxt("g")
            if ch in DIGITS:
                return nxt("x")
        elif p in ("g", "x"):
            if ch in DIGITS:
                return nxt("x")
        return None


@dataclasses.dataclass(frozen=True)
class Value(Frame):
    """Expecting the first character of a value of the given schema."""

    schema: Any  # frozen schema repr

    def _starts(self) -> list[tuple[str, list[Frame]]]:
        """(first-char, continuation frames) alternatives."""
        schema = dict(self.schema) if self.schema else {}
        out: list[tuple[str, list[Frame]]] = []
        enum = schema.get("enum")
        if enum is not None:
            for val in enum:
                if isinstance(val, str):
                    out.append(('"', [FixedString((val,))]))
                elif val is True:
                    out.append(("t", [Lit("rue")]))
                elif val is False:
                    out.append(("f", [Lit("alse")]))
                elif val is None:
                    out.append(("n", [Lit("ull")]))
                else:
                    s = repr(val) if not isinstance(val, float) else str(val)
                    s = str(val)
                    out.append((s[0], [Lit(s[1:])]))
            return out
        if "const" in schema:
            import json as _json

            s = _json.dumps(schema["const"])
            out.append((s[0], [Lit(s[1:])]))
            return out
        for alt in schema.get("oneOf", schema.get("anyOf", [])) or []:
            out.extend(Value(_freeze(alt))._starts())
        if "oneOf" in schema or "anyOf" in schema:
            return out

        t = schema.get("type")
        types = t if isinstance(t, (list, tuple)) else ([t] if t else None)
        if types is None:
            types = ["object", "array", "string", "number", "boolean", "null"]
        for typ in types:
            if typ == "object":
                out.append(("{", [Obj.start(schema)]))
            elif typ == "array":
                out.append(("[", [Arr.start(schema)]))
            elif typ == "string":
                out.append(('"', [FreeString()]))
            elif typ in ("number", "integer"):
                for c in "-" + DIGITS:
                    nf = Number("s", typ == "integer").consume(c)
                    if nf is not None:
                        out.append((c, nf))
            elif typ == "boolean":
                out.append(("t", [Lit("rue")]))
                out.append(("f", [Lit("alse")]))
            elif typ == "null":
                out.append(("n", [Lit("ull")]))
        return out

    def allowed(self):
        return {c for c, _ in self._starts()}

    def consume(self, ch):
        conts = [f for c, f in self._starts() if c == ch]
        if not conts:
            return None
        # nondeterminism resolved by the machine keeping every alternative;
        # we return the first and the machine expands the rest via fork()
        return conts[0]

    def forks(self, ch):
        return [f for c, f in self._starts() if c == ch]


def _schema_dict(frozen) -> dict:
    return dict(frozen) if frozen else {}


@dataclasses.dataclass(frozen=True)
class Obj(Frame):
    """Object frame. phase: k(expect key or close), c(expect colon),
    v(value done -> expect , or }), plus Ws/The key-string/value frames are
    pushed above."""

    schema: Any
    phase: str
    seen: tuple[str, ...] = ()
    pending_key: str = ""
    first: bool = True

    @classmethod
    def start(cls, schema: dict) -> "Obj":
        return cls(_freeze(schema), "k")

    def _props(self) -> dict:
        return dict(_schema_dict(self.schema).get("properties", ()) or ())

    def _required(self) -> list[str]:
        return list(_schema_dict(self.schema).get("required", ()) or ())

    def _additional(self) -> bool:
        sd = _schema_dict(self.schema)
        ap = sd.get("additionalProperties", not sd.get("properties"))
        return bool(ap)

    def _remaining_keys(self) -> list[str]:
        props = self._props()
        if props:
            return [k for k in props if k not in self.seen]
        return []

    def _can_close(self) -> bool:
        return all(r in self.seen for r in self._required())

    def allowed(self):
        out = set()
        if self.phase == "k":
            if self._remaining_keys() or self._additional():
                out.add('"')
            if self.first and self._can_close():
                out.add("}")
            out |= set(WS)
        elif self.phase == "c":
            out.add(":")
            out |= set(WS)
        elif self.phase == "v":
            if self._remaining_keys() or self._additional():
                out.add(",")
            if self._can_close():
                out.add("}")
            out |= set(WS)
        return out

    def consume(self, ch):
        if ch in WS:
            return [self]  # permissive whitespace inside structure
        if self.phase == "k":
            if ch == '"':
                keys = self._remaining_keys()
                if keys and not self._additional():
                    return [
                        ObjKey(self.schema, self.seen),
                        FixedString(tuple(keys)),
                    ]
                if keys or self._additional():
                    if self._additional():
                        return [ObjKeyFree(self.schema, self.seen), FreeString()]
                    return [
                        ObjKey(self.schema, self.seen),
                        FixedString(tuple(keys)),
                    ]
                return None
            if ch == "}" and self.first and self._can_close():
                return []
        elif self.phase == "c":
            if ch == ":":
                props = self._props()
                vschema = props.get(self.pending_key, {})
                # stack (bottom->top): post-value ws, the value, pre-value ws
                return [
                    Obj(self.schema, "v", self.seen, "", False),
                    Ws(),
                    Value(_freeze(vschema)),
                    Ws(),
                ]
        elif self.phase == "v":
            if ch == ",":
                if self._remaining_keys() or self._additional():
                    return [
                        Obj(self.schema, "k", self.seen, "", False),
                        Ws(),
                    ]
                return None
            if ch == "}" and self._can_close():
                return []
        return None


@dataclasses.dataclass(frozen=True)
class ObjKey(Frame):
    """Marker under a FixedString key: when the key string finishes, this
    frame records it and expects ':'."""

    schema: Any
    seen: tuple[str, ...]

    # The machine calls on_child_done(key_text) via special handling in
    # `_advance_config` — implemented through `finish_child`.
    def finish_child(self, key_text: str) -> list[Frame]:
        return [
            Obj(self.schema, "c", self.seen + (key_text,), key_text, False),
            Ws(),
        ]


@dataclasses.dataclass(frozen=True)
class ObjKeyFree(Frame):
    schema: Any
    seen: tuple[str, ...]

    def finish_child(self, key_text: str) -> list[Frame]:
        return [
            Obj(self.schema, "c", self.seen + (key_text or "_",), key_text, False),
            Ws(),
        ]


@dataclasses.dataclass(frozen=True)
class Arr(Frame):
    """Array frame; phase e(expect value or ]), s(after value: , or ])."""

    schema: Any
    phase: str
    count: int = 0

    @classmethod
    def start(cls, schema: dict) -> "Arr":
        return cls(_freeze(schema), "e")

    def _items(self) -> dict:
        return _schema_dict(_schema_dict(self.schema).get("items")) or {}

    def _bounds(self):
        sd = _schema_dict(self.schema)
        return sd.get("minItems", 0), sd.get("maxItems", 10**9)

    def allowed(self):
        lo, hi = self._bounds()
        out = set(WS)
        if self.phase == "e":
            if self.count < hi:
                out |= Value(_freeze(self._items())).allowed()
            if self.count == 0 and lo == 0:
                out.add("]")
        else:
            if self.count < hi:
                out.add(",")
            if self.count >= lo:
                out.add("]")
        return out

    def expand(self, ch):
        """Value start: splice in a Value frame and retry the char."""
        lo, hi = self._bounds()
        if (
            self.phase == "e"
            and self.count < hi
            and ch in Value(_freeze(self._items())).allowed()
        ):
            return [
                Arr(self.schema, "s", self.count + 1),
                Ws(),
                Value(_freeze(self._items())),
            ]
        return None

    def consume(self, ch):
        lo, hi = self._bounds()
        if ch in WS:
            return [self]
        if self.phase == "e":
            if ch == "]" and self.count == 0 and lo == 0:
                return []
        else:
            if ch == "," and self.count < hi:
                return [Arr(self.schema, "e", self.count), Ws()]
            if ch == "]" and self.count >= lo:
                return []
        return None


# ---------------------------------------------------------------------------
# machine
# ---------------------------------------------------------------------------


Config = tuple  # tuple[Frame, ...] — stack, last element is TOP


class JsonMachine:
    """NFA of pushdown configurations accepting (schema-constrained) JSON.

    Each configuration carries a string accumulator for the free-string
    currently being read (object keys via additionalProperties); fixed
    strings track their own prefix.
    """

    def __init__(self, schema: Optional[dict] = None):
        self.schema = schema or {}
        self.reset()

    def reset(self):
        self.configs: list[tuple[Config, str]] = [
            ((Value(_freeze(self.schema)),), "")
        ]
        self.text = ""

    # -- core ------------------------------------------------------------

    def _config_allowed(self, cfg: Config) -> set:
        out = set()
        i = len(cfg) - 1
        while i >= 0:
            f = cfg[i]
            if isinstance(f, (ObjKey, ObjKeyFree)):
                break  # markers never consume directly
            out |= set(f.allowed())
            if not f.poppable():
                break
            i -= 1
        return out

    def allowed_chars(self) -> set:
        out = set()
        for cfg, _ in self.configs:
            out |= self._config_allowed(cfg)
        return out

    def _advance_config(self, cfg: Config, acc: str, ch: str):
        """Yields (new_cfg, new_acc) for one consumed character."""
        stack = list(cfg)
        while stack:
            top = stack[-1]
            if isinstance(top, (ObjKey, ObjKeyFree)):
                return  # markers only activate via string close
            exp = top.expand(ch) if isinstance(top, Arr) else None
            if exp is not None:
                stack = stack[:-1] + exp
                continue
            if isinstance(top, Value):
                moves = top.forks(ch)
            else:
                sub = top.consume(ch)
                moves = [sub] if sub is not None else []
            if moves:
                for sub in moves:
                    nacc = acc
                    ncfg = tuple(stack[:-1]) + tuple(sub)
                    if isinstance(top, FreeString):
                        if sub == []:
                            # string closed: if a key marker sits below,
                            # splice it with the accumulated content
                            if ncfg and isinstance(
                                ncfg[-1], (ObjKey, ObjKeyFree)
                            ):
                                ncfg = tuple(ncfg[:-1]) + tuple(
                                    ncfg[-1].finish_child(acc)
                                )
                                nacc = ""
                        else:
                            nacc = acc + ch
                    elif isinstance(top, FixedString) and sub == []:
                        if ncfg and isinstance(ncfg[-1], (ObjKey, ObjKeyFree)):
                            ncfg = tuple(ncfg[:-1]) + tuple(
                                ncfg[-1].finish_child(top.prefix)
                            )
                            nacc = ""
                    yield ncfg, nacc
                return
            if top.poppable():
                stack.pop()
                continue
            return

    def advance(self, text: str) -> bool:
        """Consume text char-by-char; returns False (state unchanged) if a
        char is unacceptable in every configuration."""
        configs = self.configs
        for ch in text:
            new: list[tuple[Config, str]] = []
            seen = set()
            for cfg, acc in configs:
                for ncfg, nacc in self._advance_config(cfg, acc, ch):
                    key = (ncfg, nacc)
                    if key not in seen:
                        seen.add(key)
                        new.append((ncfg, nacc))
            if not new:
                return False
            configs = new
        self.configs = configs
        self.text += text
        return True

    def accepts_prefix(self, text: str) -> bool:
        """Would ``advance(text)`` succeed? (no state mutation)"""
        configs = self.configs
        for ch in text:
            new = []
            for cfg, acc in configs:
                new.extend(self._advance_config(cfg, acc, ch))
            if not new:
                return False
            configs = new
        return True

    @property
    def is_complete(self) -> bool:
        """Some configuration has fully consumed a valid value."""
        for cfg, _ in self.configs:
            if all(f.poppable() for f in cfg):
                return True
        return False

    def copy(self) -> "JsonMachine":
        m = JsonMachine.__new__(JsonMachine)
        m.schema = self.schema
        m.configs = list(self.configs)
        m.text = self.text
        return m
