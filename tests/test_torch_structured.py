"""The port's copy of the structured-generation package
(pie_tpu_torch/structured) held against its original: every test of
tests/test_structured.py (JSON machine acceptance, schema constraints,
token masks, the root state machine) and of tests/test_machines.py (the
composable machines) run on the port's copy, and the port's TokenMasker
against the JAX package's on the same tokenizer, state by state along a
json_schema walk and a tool-call walk."""

import json

import numpy as np
import pytest

from pie_tpu_torch.structured.json_machine import JsonMachine
from pie_tpu_torch.structured.machines import (
    ANY_CHAR,
    AnyMachine,
    FreeformMachine,
    LiteralMachine,
    SequenceMachine,
    reasoning_machine,
)
from pie_tpu_torch.structured.root import RootStateMachine
from pie_tpu_torch.structured.token_masks import TokenMasker

# -- tests/test_structured.py -------------------------------------------------------
def accepts_full(schema, text):
    m = JsonMachine(schema)
    return m.advance(text) and m.is_complete


def rejects_prefix(schema, text):
    return not JsonMachine(schema).advance(text)


def test_free_json_values():
    for text in [
        '{"a": 1, "b": [true, null, "x"]}',
        "[1, 2.5, -3e2]",
        '"hello \\"world\\""',
        "true",
        "-12.5e-3",
        "{}",
        "[]",
    ]:
        assert accepts_full(None, text), text


def test_free_json_rejections():
    for text in ["{,", "[1,,2]", "tru_", "01a", '{"a" 1}', "}", '{"a":}']:
        assert rejects_prefix(None, text) or not (
            (m := JsonMachine(None)).advance(text) and m.is_complete
        ), text


@pytest.mark.parametrize("text", ["03", "-03", "[0, 03819849]", '{"count": 00}'])
def test_leading_zero_refused_where_jax_admits_it(text):
    """An integer may not go on after a leading 0 or -0 (JSON's grammar):
    the port's Number frame refuses the digit, JAX's machine
    (pie_tpu/structured/json_machine.py, left as it is) admits it."""
    from pie_tpu.structured.json_machine import JsonMachine as JJson

    assert not JsonMachine(None).advance(text)
    jm = JJson(None)
    assert jm.advance(text) and (jm.is_complete or text[0] in "[{")


@pytest.mark.parametrize("text", ["0", "-0", "0.5", "-0.25e3", "0e1", "[0, 10, 100]",
                                  '{"n": 0}'])
def test_leading_zero_then_fraction_exponent_or_end(text):
    """After a leading zero, ".", "e" or the end: still accepted."""
    assert accepts_full(None, text)
    for schema in ({"type": "integer"},):
        if "." not in text and "e" not in text and text.lstrip("-").isdigit():
            assert accepts_full(schema, text)


def test_incomplete_not_complete():
    m = JsonMachine(None)
    assert m.advance('{"a": [1, 2')
    assert not m.is_complete
    assert m.advance("]}")
    assert m.is_complete


def test_schema_object_properties():
    schema = {
        "type": "object",
        "properties": {
            "name": {"type": "string"},
            "age": {"type": "integer"},
        },
        "required": ["name"],
        "additionalProperties": False,
    }
    assert accepts_full(schema, '{"name": "bob"}')
    assert accepts_full(schema, '{"name": "bob", "age": 3}')
    assert accepts_full(schema, '{"age": 3, "name": "x"}')
    # unknown property rejected at the key
    assert rejects_prefix(schema, '{"zzz"')
    # age must be integer
    assert rejects_prefix(schema, '{"name": "b", "age": "x"')
    assert rejects_prefix(schema, '{"name": "b", "age": 1.')
    # required missing -> close not allowed
    assert rejects_prefix(schema, '{"age": 1}')
    # duplicate key rejected
    assert rejects_prefix(schema, '{"name": "a", "name"')


def test_schema_enum_and_nested():
    schema = {
        "type": "object",
        "properties": {
            "color": {"enum": ["red", "green"]},
            "point": {
                "type": "object",
                "properties": {"x": {"type": "number"}},
                "required": ["x"],
            },
        },
        "required": ["color"],
    }
    assert accepts_full(schema, '{"color": "red"}')
    assert accepts_full(schema, '{"color": "green", "point": {"x": 1.5}}')
    assert rejects_prefix(schema, '{"color": "blu')


def test_schema_array_oneof():
    one = {
        "oneOf": [
            {
                "type": "object",
                "properties": {"name": {"enum": ["f"]}, "arguments": {"type": "object"}},
                "required": ["name"],
                "additionalProperties": False,
            },
            {
                "type": "object",
                "properties": {"name": {"enum": ["g"]}, "n": {"type": "integer"}},
                "required": ["name"],
                "additionalProperties": False,
            },
        ]
    }
    schema = {"type": "array", "items": one, "minItems": 1}
    assert accepts_full(schema, '[{"name": "f"}]')
    assert accepts_full(schema, '[{"name": "g", "n": 2}, {"name": "f"}]')
    assert rejects_prefix(schema, "[]")  # minItems 1
    assert rejects_prefix(schema, '[{"name": "h"')


def test_whitespace_tolerated_but_bounded():
    assert accepts_full(None, '{ "a": 1 }')
    m = JsonMachine(None)
    assert not m.advance("      {")  # > MAX_WS_RUN leading spaces... rejected


class _FakeTok:
    """Char-level fake tokenizer: token id == ord(char); a few multi-char
    tokens at the top."""

    MULTI = ['{"', '"}', '": ', "true", "false", "null", '{"name"']

    def __init__(self):
        self.vocab_size = 256 + len(self.MULTI)

    def decode(self, ids):
        out = []
        for t in ids:
            if t < 256:
                out.append(chr(t))
            else:
                out.append(self.MULTI[t - 256])
        return "".join(out)


def test_token_masks_constrain_and_multichar():
    masker = TokenMasker(_FakeTok())
    m = JsonMachine({"type": "object", "properties": {"name": {"type": "string"}},
                     "required": ["name"], "additionalProperties": False})
    mask = masker.build_mask(m)
    assert mask[ord("{")]
    assert mask[256 + 0]  # '{"'
    assert mask[256 + len(_FakeTok.MULTI) - 1]  # '{"name"'
    assert not mask[ord("[")]
    assert not mask[ord("a")]
    # advance with a multi-char token and re-mask
    assert m.advance('{"name"')
    mask = masker.build_mask(m)
    # after the key string closed, next must be ':' (or ws); '"' is invalid
    assert mask[ord(":")]
    assert not mask[ord('"')]


def test_token_mask_full_json_generation_walk():
    """Greedy-walk the mask until completion -> output must be valid JSON
    conforming to the schema."""
    rng = np.random.default_rng(0)
    masker = TokenMasker(_FakeTok())
    schema = {
        "type": "object",
        "properties": {
            "name": {"enum": ["alpha", "beta"]},
            "count": {"type": "integer"},
        },
        "required": ["name", "count"],
        "additionalProperties": False,
    }
    m = JsonMachine(schema)
    out = []
    for _ in range(200):
        if m.is_complete:
            break
        mask = masker.build_mask(m)
        ids = np.nonzero(mask)[0]
        assert len(ids) > 0, f"dead end after {''.join(out)!r}"
        tid = int(rng.choice(ids))
        s = masker.token_strs[tid]
        assert m.advance(s)
        out.append(s)
    text = "".join(out)
    data = json.loads(text)
    assert data["name"] in ("alpha", "beta")
    assert isinstance(data["count"], int)


def test_root_state_machine_mapping():
    r = RootStateMachine()
    s = r.configure(response_format={"type": "json_object"})
    assert s.name == "structured_output" and s.machine is not None
    s = r.configure(
        response_format={
            "type": "json_schema",
            "json_schema": {"name": "x", "schema": {"type": "object"}},
        }
    )
    assert s.name == "structured_output"
    tools = [{"type": "function", "function": {"name": "get_w", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"]}}}]
    s = r.configure(tools=tools, tool_choice="required")
    assert s.name == "tool_call"
    assert s.generation_kwargs["temperature"] == 0.0
    assert s.machine.advance('{"name": "get_w", "arguments": {"city": "x"}}')
    assert s.machine.is_complete
    # named tool choice
    s = r.configure(
        tools=tools, tool_choice={"type": "function", "function": {"name": "get_w"}},
    )
    assert s.name == "tool_call"
    # auto -> text (unconstrained; host-side parsing)
    s = r.configure(tools=tools, tool_choice="auto")
    assert s.name == "text"
    label, val = RootStateMachine.labeled_output(
        r.configure(tools=tools, tool_choice="required"),
        '{"name": "get_w", "arguments": {"city": "sf"}}',
    )
    assert label == "tool_calls"
    assert val[0]["name"] == "get_w"


# -- tests/test_machines.py ---------------------------------------------------------
def test_literal():
    m = LiteralMachine("<think>")
    assert m.allowed_chars() == {"<"}
    assert m.accepts_prefix("<think>")
    assert not m.accepts_prefix("<thonk")
    assert m.advance("<think")
    assert not m.is_complete
    assert m.advance(">")
    assert m.is_complete
    assert m.allowed_chars() == set()


def test_freeform_delimited():
    m = FreeformMachine(end_delimiters=("</s>",))
    assert ANY_CHAR in m.allowed_chars()
    assert m.advance("hello world")
    assert not m.is_complete
    assert m.advance("</s>")
    assert m.is_complete
    assert m.body == "hello world"
    assert not m.advance("x")  # nothing after the delimiter


def test_sequence_hands_over():
    m = SequenceMachine(
        [LiteralMachine("ab"), LiteralMachine("cd")], names=["a", "b"]
    )
    assert m.advance("a")
    assert m.active_names() == {"a"}
    assert m.advance("bc")
    assert m.active_names() == {"b"}
    assert not m.is_complete
    assert m.advance("d")
    assert m.is_complete
    assert not m.advance("e")


def test_sequence_rejects_wrong_order():
    m = SequenceMachine([LiteralMachine("ab"), LiteralMachine("cd")])
    assert not m.advance("c")
    assert m.advance("ab")  # state unchanged by the failed advance


def test_any_machine_branches():
    m = AnyMachine(
        [LiteralMachine("yes"), LiteralMachine("yodel")], names=["y1", "y2"]
    )
    assert m.allowed_chars() == {"y"}
    assert m.advance("y")
    assert m.active_names() == {"y1", "y2"}
    assert m.advance("e")
    assert m.active_names() == {"y1"}
    assert m.advance("s")
    assert m.is_complete


def test_any_with_json():
    m = AnyMachine([JsonMachine({"type": "object"}), LiteralMachine("none")])
    m2 = m.copy()
    assert m.advance('{"a": 1}')
    assert m.is_complete
    assert m2.advance("none")
    assert m2.is_complete


def test_reasoning_then_json():
    inner = JsonMachine({"type": "object", "properties": {"x": {"type": "integer"}},
                         "required": ["x"], "additionalProperties": False})
    m = reasoning_machine(inner)
    assert m.allowed_chars() == {"<"}
    assert m.advance("<think>")
    assert ANY_CHAR in m.allowed_chars()
    assert m.advance("let me think about it...")
    assert not m.is_complete
    assert m.advance("</think>")
    assert "{" in m.allowed_chars()
    assert m.advance('{"x": 42}')
    assert m.is_complete
    assert "reasoning" not in m.active_names()


def test_reasoning_freeform_output():
    m = reasoning_machine(None, stop=("<eot>",))
    assert m.advance("<think>hm</think>some answer")
    assert not m.is_complete
    assert m.advance("<eot>")
    assert m.is_complete


def test_accepts_prefix_no_mutation():
    m = reasoning_machine(JsonMachine({"type": "object"}))
    m.advance("<think>x</think>")
    before = m.text
    assert m.accepts_prefix('{"k"')
    assert not m.accepts_prefix("nope")
    assert m.text == before
    assert m.advance("{}")
    assert m.is_complete


def test_root_reasoning_configure_and_label():
    from pie_tpu_torch.structured.root import RootStateMachine

    root = RootStateMachine()
    st = root.configure(
        response_format={"type": "json_schema", "json_schema": {
            "schema": {"type": "object", "properties": {"a": {"type": "integer"}},
                       "required": ["a"], "additionalProperties": False}}},
        reasoning=True,
    )
    assert st.machine is not None
    assert st.name == "reasoning+structured_output"
    assert st.machine.advance('<think>reason</think>{"a": 7}')
    assert st.machine.is_complete
    label, value = RootStateMachine.labeled_output(
        st, '<think>reason</think>{"a": 7}'
    )
    assert label == "json"
    assert value == {"a": 7}

# -- the port's TokenMasker against the JAX package's -----------------------------------


def _walk(machine_pair, masker_pair, choose):
    """Advance a (JAX, port) pair of machines together, token by token
    (``choose`` picks among the allowed ids), checking at every state that
    both maskers build the same mask and the same forced-run encoding.
    Returns the text and the number of states compared."""
    jm, tm = machine_pair
    jmask, tmask = masker_pair
    text, states = [], 0
    for _ in range(400):
        if tm.is_complete:
            assert jm.is_complete
            break
        want, got = jmask.build_mask(jm), tmask.build_mask(tm)
        np.testing.assert_array_equal(got, want)
        states += 1
        ids = np.nonzero(got)[0]
        assert len(ids) > 0, f"dead end after {''.join(text)!r}"
        tid = int(choose(ids))
        s = tmask.token_strs[tid]
        assert jmask.token_strs[tid] == s
        assert tm.advance(s) and jm.advance(s)
        text.append(s)
    return "".join(text), states


def _word_maskers():
    pytest.importorskip("transformers")
    from pie_tpu.structured.token_masks import TokenMasker as JMasker

    from test_torch_constrained_engine import port_tokenizer

    tok = port_tokenizer()
    return JMasker(tok), TokenMasker(tok)


@pytest.mark.parametrize("tokenizer", ["chars", "words"])
def test_masker_matches_jax_along_json_schema_walk(tokenizer):
    from pie_tpu.structured.json_machine import JsonMachine as JJson
    from pie_tpu.structured.token_masks import TokenMasker as JMasker

    schema = {
        "type": "object",
        "properties": {
            "name": {"enum": ["alpha", "beta"]},
            "count": {"type": "integer"},
            "city": {"type": "string"},
        },
        "required": ["name", "count", "city"],
        "additionalProperties": False,
    }
    maskers = ((JMasker(_FakeTok()), TokenMasker(_FakeTok())) if tokenizer == "chars"
               else _word_maskers())
    jm, tm = maskers
    assert jm.token_strs == tm.token_strs
    rng = np.random.default_rng(1)
    machines = (JJson(schema), JsonMachine(schema))
    text, states = _walk(machines, maskers, lambda ids: rng.choice(ids))
    assert states > 5 and machines[1].is_complete == machines[0].is_complete
    assert text.startswith("{")
    # the forced-run encoding of the structural text is the same
    assert jm.encode_longest('{"name": "alpha"}') == tm.encode_longest('{"name": "alpha"}')


@pytest.mark.parametrize("tokenizer", ["chars", "words"])
def test_masker_matches_jax_along_tool_call_walk(tokenizer):
    from pie_tpu.structured.root import RootStateMachine as JRoot

    tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"], "additionalProperties": False}}}]
    from pie_tpu.structured.token_masks import TokenMasker as JMasker

    maskers = ((JMasker(_FakeTok()), TokenMasker(_FakeTok())) if tokenizer == "chars"
               else _word_maskers())
    kw = dict(tools=tools, tool_choice="required", reasoning=True)
    jst, tst = JRoot().configure(**kw), RootStateMachine().configure(**kw)
    assert (tst.name, tst.state_kwargs, tst.generation_kwargs) == (
        jst.name, jst.state_kwargs, jst.generation_kwargs)
    rng = np.random.default_rng(2)

    def choose(ids):
        # prefer short tokens so the freeform <think> phase ends: '<' opens
        # the close tag, then the machine forces it
        return ids[0] if len(ids) == 1 else rng.choice(ids)

    text, states = _walk((jst.machine, tst.machine), maskers, choose)
    assert states > 5 and text.startswith("<think>")
    assert RootStateMachine.labeled_output(tst, text) == JRoot.labeled_output(jst, text)
